"""PyTorch port, distributed part two: the pipeline schedules, the GPT
pipe, the vocab-sharded head, ``PipelineLayer`` / ``PipelineParallel``
and config #5's dp x pp x mp, on one pool of eight gloo rank processes
(``_torch_port_dist_workers.RankPool``, one torch thread each).

Each pp rank holds only its stage, so the port's runs are held to the
reference's single-controller runs on the same weights and inputs: the
toy ``(W, b)`` block to ``spmd_pipeline`` / ``spmd_pipeline_1f1b`` on
an explicit ``(dp, pp)`` mesh (rtol 1e-5), the GPT pipe to the
reference's ``GPTForCausalLMPipe`` on an explicit pp mesh and config #5
to the reference's unsharded ``TrainStep`` (rtol 2e-4, atol 2e-5, as
``tests/test_gpt_hybrid.py`` holds the reference's own runs).  The
reference's ``fleet.init`` is never called here: its topology is
process-wide."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer,
    PipelineParallel as JPipelineParallel, SharedLayerDesc as JShared,
    pipeline_tick_stats as j_tick_stats, spmd_pipeline as j_spmd,
    spmd_pipeline_1f1b as j_spmd_1f1b)
from paddle_tpu.distributed.fleet.meta_parallel.mp_layers import (
    sharded_vocab_head_loss as j_head_loss)
from paddle_tpu.text.models.gpt import (GPTForCausalLM as JGPT,
                                        GPTForCausalLMPipe as JGPTPipe)
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    pipeline_tick_stats)
from _torch_port_dist_workers import RankPool
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

RS = np.random.RandomState(0)
CFG = dict(vocab_size=64, hidden_size=16, num_hidden_layers=4,
           num_attention_heads=2, max_position_embeddings=32)
IDS = np.random.RandomState(0).randint(1, 64, (8, 12)).astype("int64")
STEPS, LR = 4, 1e-3
GPT_TOL = dict(rtol=2e-4, atol=2e-5)
TOY_TOL = dict(rtol=1e-5, atol=1e-6)
SCHEDULES = ("gpipe", "1f1b", "interleaved")


class _Pool(RankPool):
    """The rank pool, its results without the idle dp replicas' (a job
    that needs fewer ranks than the world leaves the rest idle: None)."""

    def collect(self, job, timeout=120.0):
        return [r for r in super().collect(job, timeout) if r is not None]


@pytest.fixture(scope="module")
def pool():
    p = _Pool(8)
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(m):
    return {k: np.array(np.asarray(v._value), copy=True)
            for k, v in m.state_dict().items()}


def _close(got, want, tol, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _close_gpt(got, want, steps):
    """The GPT weights at ``GPT_TOL``, but the key part of each qkv bias:
    its gradient is 0 in exact arithmetic (adding a constant to every key
    shifts a softmax row by a constant), so Adam's update of it is rounding
    noise over its running RMS, up to the learning rate a step, in
    either package; it is held to that bound."""
    heads, hd = CFG["num_attention_heads"], \
        CFG["hidden_size"] // CFG["num_attention_heads"]
    key = np.zeros((heads, 3, hd), bool)
    key[:, 1] = True
    key = key.reshape(-1)
    for k in want:
        if k.endswith(".qkv.bias"):
            np.testing.assert_allclose(got[k][~key], want[k][~key],
                                       err_msg=k, **GPT_TOL)
            assert np.abs(got[k][key] - want[k][key]).max() \
                <= 2 * steps * LR, k
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **GPT_TOL)


# ------------------------------------------------------------ (1) tick stats
@pytest.mark.parametrize("schedule", ["gpipe", "interleaved", "1f1b"])
def test_tick_stats_equal_the_reference(schedule):
    for M in (1, 2, 4, 7, 8, 16):
        for S in (1, 2, 4):
            for v in (1, 2, 3):
                assert pipeline_tick_stats(M, S, v, schedule) == \
                    j_tick_stats(M, S, v, schedule), (M, S, v)


# ------------------------------------------------------- (2) the toy block
def _toy(S, v):
    M, micro, D = 8, 2, 12
    rng = np.random.RandomState(S * 10 + v)
    lead = (S, v) if v > 1 else (S,)
    return {"W": (rng.randn(*lead, D, D) * 0.3).astype("float32"),
            "b": (rng.randn(*lead, D) * 0.1).astype("float32"),
            "x": rng.randn(M, micro, D).astype("float32"),
            "dy": rng.randn(M, micro, D).astype("float32")}


def _block(params, h):
    W, b = params
    return jnp.tanh(h @ W + b)


def _jax_toy(a, S, schedule):
    """The reference's output, its gradients for the cotangent ``dy``
    and the ``pp_ppermute`` bytes its one call records."""
    from paddle_tpu.profiler import metrics

    def pp_bytes():
        fam = metrics.get_registry().counter("collective.bytes")
        return sum(v for _, lab, v in fam.samples()
                   if lab.get("op") == "pp_ppermute")

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8 // S, S),
                ("dp", "pp"))
    if schedule == "1f1b":
        def f(W, b, x):
            return j_spmd_1f1b(_block, (W, b), x, mesh, axis="pp")
    else:
        def f(W, b, x):
            return j_spmd(_block, (W, b), x, mesh, axis="pp",
                          schedule=schedule)
    before = pp_bytes()
    out, back = jax.vjp(f, *(jnp.asarray(a[k]) for k in ("W", "b", "x")))
    grads = back(jnp.asarray(a["dy"]))
    return (np.asarray(out), [np.asarray(g) for g in grads],
            pp_bytes() - before)


@pytest.fixture(scope="module")
def toy_runs(pool):
    """Every (pp, schedule) run of the toy block on the ranks, each beside
    the reference's."""
    out = {}
    for S in (2, 4):
        for schedule in SCHEDULES:
            a = _toy(S, 2 if schedule == "interleaved" else 1)
            pool.submit("pp_toy", a, S, schedule)
            ref = _jax_toy(a, S, schedule)
            out[S, schedule] = (pool.collect("pp_toy"), ref)
    return out


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_toy_pipeline_matches_the_reference(toy_runs, S, schedule):
    """Output and the gradients of W, b and x at rtol 1e-5: each stage
    holds its slice, every stage returns the output and x's gradient."""
    ranks, (out, (gW, gb, gx), _) = toy_runs[S, schedule]
    for r in ranks:
        np.testing.assert_allclose(r["out"], out, **TOY_TOL)
        np.testing.assert_allclose(r["dx"], gx, **TOY_TOL)
        np.testing.assert_allclose(r["dW"], gW[r["stage"]], **TOY_TOL)
        np.testing.assert_allclose(r["db"], gb[r["stage"]], **TOY_TOL)
    assert sorted({r["stage"] for r in ranks}) == list(range(S))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pp_ppermute_bytes_equal_the_reference(toy_runs, S, schedule):
    """(11) ``collective.bytes{op="pp_ppermute"}`` of one eager call is
    the reference's (one micro-batch a tick), and the hops are real
    broadcasts."""
    ranks, (_, _, ref_bytes) = toy_runs[S, schedule]
    assert ref_bytes > 0
    for r in ranks:
        assert r["pp_bytes"] == ref_bytes
        assert r["broadcasts"] > 0


def test_no_remat_keeps_the_numbers(pool, toy_runs):
    a = _toy(2, 1)
    _, (out, (gW, gb, gx), _) = toy_runs[2, "gpipe"]
    for r in pool.run("pp_toy", a, 2, "gpipe", remat=False):
        np.testing.assert_allclose(r["out"], out, **TOY_TOL)
        np.testing.assert_allclose(r["dW"], gW[r["stage"]], **TOY_TOL)
        np.testing.assert_allclose(r["dx"], gx, **TOY_TOL)


def test_a_stalled_stage_fires_the_watchdog_on_the_hop(pool, toy_runs,
                                                      tmp_path):
    """Stage 0 stalls 1.5 s in its first hop (pp = 4): every other
    stage's collective watchdog (deadline 0.3 s) reports its stuck hop,
    a broadcast between two stages, or the wait it leads to, and the
    pipeline's output once the stage resumes is the reference's."""
    a = _toy(4, 1)
    _, (out, _, _) = toy_runs[4, "gpipe"]
    res = pool.run("pp_stalled_stage", a, 0.3, 1.5, str(tmp_path))
    for r in res:
        np.testing.assert_allclose(r["out"], out, **TOY_TOL)
        if r["stage"] == 1:     # waits on stage 0's hop to it
            assert any(f["op"] == "broadcast" and f["nranks"] == 2
                       for f in r["fired"]), r["fired"]
    assert all(r["fired"] for r in res if r["stage"] != 0)


# ---------------------------------------------------------- (12) the errors
def test_the_reference_errors(pool):
    a = _toy(2, 1)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    W, b, x = (jnp.asarray(a[k]) for k in ("W", "b", "x"))
    want = {}
    for name, call in (
            ("m_lt_s", lambda: j_spmd(_block, (W, b), x[:1], mesh)),
            ("m_lt_s_1f1b", lambda: j_spmd_1f1b(_block, (W, b), x[:1], mesh)),
            ("schedule", lambda: j_spmd(_block, (W, b), x, mesh,
                                        schedule="zb")),
            ("interleaved_m", lambda: j_spmd(
                _block, (W[:, None], b[:, None]), x[:3], mesh,
                schedule="interleaved"))):
        with pytest.raises(ValueError) as e:
            call()
        want[name] = str(e.value)
    for r in pool.run("pp_errors", a):
        for name, msg in want.items():
            assert r[name] == msg, name
        assert "stage_params leading dims" in r["stage_dim"]


# ------------------------------------------------------------- GPT pipes
@pytest.fixture(scope="module")
def gpt_state():
    paddle.seed(7)
    return _np_state(JGPT(**CFG))


def _lm(state):
    return {"lm." + k: v for k, v in state.items()}


def test_pipeline_forward_eval_matches_the_plain_forward(pool, gpt_state):
    """(3) Eval hidden at pp 2 (gpipe, interleaved) and pp 2 x mp 2
    against the reference GPT's plain forward, by ``pipeline_forward`` and
    by ``spmd_pipeline`` over ``stack_block_params``; a stage holds its
    blocks only (interleaved: layer j on stage j % 2)."""
    ref = JGPT(**CFG)
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in gpt_state.items()})
    ref.eval()
    want = np.asarray(ref.gpt(paddle.to_tensor(IDS))._value)
    for pp, mp, schedule in ((2, 1, "gpipe"), (2, 1, "interleaved"),
                             (2, 2, "gpipe")):
        res = pool.run("pp_gpt_forward", _lm(gpt_state), IDS, CFG, pp, mp,
                       schedule)
        for r in res:
            np.testing.assert_allclose(r["hidden"], want, rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(r["hidden_stacked"], want, rtol=1e-4,
                                       atol=1e-5)
            held = [j for j in range(4) if (j % 2 if schedule ==
                                            "interleaved" else j // 2)
                    == r["stage"]]
            assert r["blocks"] == held


def _jax_pipe_run(state, schedule):
    paddle.seed(7)
    lm = JGPT(**CFG)
    pipe = JGPTPipe(lm, Mesh(np.asarray(jax.devices()[:2]), ("pp",)),
                    n_micro=4, schedule=schedule)
    pipe.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    o = jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                   parameters=pipe.parameters(),
                   grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    step = paddle.jit.TrainStep(pipe, o, loss_fn=None)
    t = paddle.to_tensor(IDS)
    losses = [float(step({"input_ids": t, "labels": t}))
              for _ in range(STEPS)]
    return losses, _np_state(pipe)


@pytest.fixture(scope="module")
def pipe_runs(pool, gpt_state):
    out = {}
    for schedule in SCHEDULES:
        pool.submit("pp_gpt_train", _lm(gpt_state), IDS, CFG, STEPS, LR,
                    schedule)
        ref = _jax_pipe_run(_lm(gpt_state), schedule)
        out[schedule] = (pool.collect("pp_gpt_train"), ref)
    return out


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_gpt_pipe_trains_like_the_reference_pipe(pipe_runs, schedule):
    """(4) 4 AdamW steps (ClipGradByGlobalNorm(1.0)) at pp = 2: every
    rank's losses and the weights gathered from the stages are the
    reference ``GPTForCausalLMPipe``'s."""
    ranks, (losses, state) = pipe_runs[schedule]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, **GPT_TOL)
        _close_gpt(r["final"], state, STEPS)
    assert losses[-1] < losses[0]


def test_a_stage_holds_and_updates_only_its_blocks(pipe_runs):
    """Each rank holds 2 of the 4 blocks, plus the embeddings and the
    final LayerNorm, and keeps optimizer moments for exactly those."""
    for schedule, (ranks, _) in pipe_runs.items():
        for r in ranks:
            want = [j for j in range(4) if (j % 2 if schedule ==
                                            "interleaved" else j // 2)
                    == r["stage"]]
            assert r["held"] == want
            assert r["n_moments"] == r["n_params"] == 2 * 12 + 4
            assert set(r["calls"]) <= {"broadcast", "all_gather_object",
                                       "all_reduce", "pp_ppermute"}


# ------------------------------------------------- (5) config #5: dp x pp x mp
def _jax_unsharded(state, steps, amp_level=None, accumulate_steps=1):
    """The reference's unsharded ``TrainStep`` (AdamW,
    ClipGradByGlobalNorm(1.0)) on ``IDS``: its losses and weights."""
    paddle.seed(7)
    j = JGPT(**CFG)
    j.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    o = jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                   parameters=j.parameters(),
                   grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    step = paddle.jit.TrainStep(j, o, loss_fn=None, amp_level=amp_level,
                                accumulate_steps=accumulate_steps)
    t = paddle.to_tensor(IDS)
    losses = [float(step({"input_ids": t, "labels": t}))
              for _ in range(steps)]
    return losses, _lm(_np_state(j))


def _port_unsharded(state, steps, amp_level=None, accumulate_steps=1):
    """The port's unsharded ``TrainStep`` of the same run."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              export_paddle_tpu_state_dict,
                                              load_paddle_tpu_state_dict)

    lm = GPTForCausalLM(device="cpu", **CFG)
    load_paddle_tpu_state_dict(lm, state)
    o = topt.AdamW(learning_rate=LR, weight_decay=0.01,
                   parameters=lm.parameters(),
                   grad_clip=topt.ClipGradByGlobalNorm(1.0))
    step = jit.TrainStep(lm, o, loss_fn=None, amp_level=amp_level,
                         accumulate_steps=accumulate_steps)
    ids = torch.from_numpy(IDS)
    losses = [float(step({"input_ids": ids, "labels": ids}))
              for _ in range(steps)]
    return losses, _lm(export_paddle_tpu_state_dict(lm))


@pytest.fixture(scope="module")
def unsharded(gpt_state):
    return _jax_unsharded(gpt_state, STEPS)


def _same_on_every_rank(res, keys):
    """Every rank (the dp replicas too) exports the same weights, bit for
    bit: a dp rank that stepped on its own rows' gradient would not."""
    for r in res:
        for k in keys:
            np.testing.assert_array_equal(r["final"][k], res[0]["final"][k],
                                          err_msg=k)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_config5_dp2_pp2_mp2_matches_the_unsharded_reference(
        pool, gpt_state, unsharded, schedule):
    """dp 2 x pp 2 x mp 2 on the eight ranks (each dp rank its block of
    every micro-batch, the vocab-sharded head, the clip's norm over pp x
    mp): the losses and the weights gathered by stage and shard are the
    reference's unsharded TrainStep's."""
    losses, state = unsharded
    res = pool.run("pp_gpt_train", _lm(gpt_state), IDS, CFG, STEPS, LR,
                   schedule, dp=2, pp=2, mp=2)
    assert sorted((r["dp_rank"], r["stage"], r["mp_rank"]) for r in res) \
        == [(d, s, m) for d in range(2) for s in range(2) for m in range(2)]
    _same_on_every_rank(res, state)
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, **GPT_TOL)
        _close_gpt(r["final"], state, STEPS)


AMP_STEPS = 3


def _key_bias(k):
    """The key part of a qkv bias (see ``_close_gpt``), else None."""
    if not k.endswith(".qkv.bias"):
        return None
    heads = CFG["num_attention_heads"]
    key = np.zeros((heads, 3, CFG["hidden_size"] // heads), bool)
    key[:, 1] = True
    return key.reshape(-1)


def _update_err(got, want, init):
    """``|dgot - dwant| / |dwant|`` over the updates of every weight from
    ``init`` in one vector, the key part of each qkv bias left out."""
    def update(state):
        parts = []
        for k in sorted(init):
            d = state[k] - init[k]
            key = _key_bias(k)
            parts.append((d if key is None else d[~key]).ravel())
        return np.concatenate(parts)

    dw = update(want)
    return np.linalg.norm(update(got) - dw) / np.linalg.norm(dw)


def _loss_gap(got, want):
    return float(np.max(np.abs(np.subtract(got, want)) / np.abs(want)))


@pytest.fixture(scope="module")
def amp_refs(gpt_state):
    """For the pipe's gradient-merge run (f32, ``accumulate_steps=2``)
    and its O1 and O2 runs: the reference's unsharded ``TrainStep`` with
    the same ``amp_level`` and ``accumulate_steps``, and the rounding
    control, the port's unsharded ``TrainStep`` of the same run (its
    distance to the reference is what two right programs differ by at
    that precision)."""
    return {(level, acc): (_jax_unsharded(gpt_state, AMP_STEPS, level, acc),
                           _port_unsharded(gpt_state, AMP_STEPS, level, acc))
            for level, acc in ((None, 2), ("O1", 1), ("O2", 1))}


def test_config5_trains_at_o1_o2_and_with_accumulation(pool, gpt_state,
                                                       amp_refs):
    """Config #5 (dp 2 x pp 2 x mp 2) through ``TrainStep`` under each
    schedule, held to the reference's unsharded ``TrainStep`` of the same
    ``amp_level`` and ``accumulate_steps`` on the same weights and ids:

    - ``accumulate_steps=2`` at f32 (2 micro-batches a slice): the
      losses at rtol 1e-5, the weights at rtol 2e-4, atol 2e-5;
    - O1 and O2 (bf16; O2 on bf16 copies of f32 masters): the losses and
      the weights' update within twice the rounding control's distance
      to the reference, and the blocks' qkv projection ran in bf16.

    Every rank exports the same weights, bit for bit."""
    init = _lm(gpt_state)
    for level, acc, n_micro in ((None, 2, 2), ("O1", 1, 4), ("O2", 1, 4)):
        (losses, state), (c_losses, c_state) = amp_refs[level, acc]
        loss_tol = 2 * _loss_gap(c_losses, losses)
        update_tol = 2 * _update_err(c_state, state, init)
        for schedule in SCHEDULES:
            what = f"amp_level={level} accumulate_steps={acc} {schedule}"
            res = pool.run("pp_gpt_train", init, IDS, CFG, AMP_STEPS, LR,
                           schedule, dp=2, pp=2, mp=2, amp_level=level,
                           accumulate_steps=acc, n_micro=n_micro)
            _same_on_every_rank(res, init)
            got = res[0]
            assert got["qkv_dtypes"] == ["torch.bfloat16" if level
                                         else "torch.float32"], what
            if level is None:
                np.testing.assert_allclose(got["losses"], losses,
                                           err_msg=what, rtol=1e-5)
                _close_gpt(got["final"], state, AMP_STEPS)
                continue
            assert _loss_gap(got["losses"], losses) <= loss_tol, \
                (what, got["losses"], losses, loss_tol)
            err = _update_err(got["final"], state, init)
            assert err <= update_tol, (what, err, update_tol)


# ----------------------------------------------- (6) the vocab-sharded head
def test_sharded_vocab_head_loss_matches_the_reference(pool):
    rng = np.random.RandomState(5)
    h = rng.randn(2, 5, 8).astype("float32")
    w = rng.randn(16, 8).astype("float32")
    y = rng.randint(0, 16, (2, 5)).astype("int64")
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("mp",))
    ht = paddle.to_tensor(h, stop_gradient=False)
    wt = paddle.to_tensor(w, stop_gradient=False)
    loss = j_head_loss(ht, wt, paddle.to_tensor(y), mesh)
    loss.backward()
    dh, dw = np.asarray(ht.grad._value), np.asarray(wt.grad._value)
    for r in pool.run("pp_head_loss", h, w, y):
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        np.testing.assert_allclose(r["dh"], dh, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r["dw"], np.split(dw, 2)[r["mp_rank"]],
                                   rtol=1e-5, atol=1e-7)


# ------------------------------------- (7) PipelineLayer / PipelineParallel
def _jax_descs():
    def head(layer, x):
        return paddle.matmul(x, layer.weight, transpose_y=True)

    return ([JShared("emb", jnn.Embedding, None, "weight", 16, 8)]
            + [JLayerDesc(jnn.Linear, 8, 8), jnn.Tanh()] * 3
            + [JShared("emb", jnn.Embedding, head, "weight", 16, 8)])


def test_pipeline_layer_train_batch_matches_the_reference(pool):
    """``fleet.distributed_model(PipelineLayer)`` at pp = 2 is a
    ``PipelineParallel``; three ``train_batch`` calls (SGD, 2 micro-batches,
    the tied embedding shared by both stages) give the reference's
    ``segment_parts``, losses and weights."""
    import paddle_tpu.distributed.fleet as jfleet
    from paddle_tpu.jit.train_step import TrainStep as JTrainStep

    paddle.seed(3)
    pl = JPipelineLayer(_jax_descs(), num_stages=2,
                        loss_fn=jnn.CrossEntropyLoss())
    state = _np_state(pl)
    st = jfleet.DistributedStrategy()
    st.pipeline_configs = {"accumulate_steps": 2}
    model = JPipelineParallel(pl, None, st)
    o = jopt.SGD(learning_rate=0.5, parameters=model.parameters())
    # the reference's own step, built without donation: the shared layer
    # is listed twice among its parameters
    model._train_step = JTrainStep(pl, o, loss_fn=pl._loss_fn,
                                   accumulate_steps=2, donate=False)
    x = np.random.RandomState(0).randint(0, 16, (8,)).astype("int64")
    y = np.random.RandomState(1).randint(0, 16, (8,)).astype("int64")
    losses = [float(model.train_batch((paddle.to_tensor(x),
                                       paddle.to_tensor(y)), o))
              for _ in range(3)]
    final = _np_state(pl)
    for r in pool.run("pp_layer_train", state, x, y, 3, 0.5, 2):
        assert r["wrapped"]
        assert r["segment_parts"] == pl.segment_parts == [0, 4, 8]
        assert r["own"] == ["0.weight", "1.bias", "1.weight", "3.bias",
                            "3.weight"] if r["stage"] == 0 else \
            ["5.bias", "5.weight", "7.weight"]
        np.testing.assert_allclose(r["losses"], losses, **GPT_TOL)
        _close(r["final"], final, GPT_TOL)


# ------------------------------------------------ (8) schedule from strategy
def test_schedule_from_strategy(pool):
    """``pipeline_configs['schedule_mode']`` picks the schedule by the
    reference's table (``test_gpt_pipe_schedule_from_strategy``): 1F1B,
    Interleave, an explicit argument wins, an unknown mode warns and
    falls back to gpipe; 1F1B's numerics are gpipe's."""
    for r in pool.run("pp_strategy"):
        assert r["kept"] == "1F1B"
        assert r["mode_1f1b"] == "1f1b"
        np.testing.assert_allclose(r["loss_1f1b"], r["loss_gpipe"],
                                   rtol=2e-5)
        assert r["mode_interleave"] == "interleaved"
        assert np.isfinite(r["loss_interleave"])
        assert r["mode_explicit"] == "gpipe"
        assert r["mode_unknown"] == "gpipe" and r["warned"]


# ------------------------------------------------ (9) the clip under pp x mp
def test_global_norm_under_pp_and_mp_is_the_references(pool, gpt_state):
    """ClipGradByGlobalNorm's norm at pp 2 x mp 2 (blocks summed over pp,
    shards over mp, each replica once) equals the norm over the
    reference's gradients of the whole model."""
    j = JGPT(**CFG)
    j.set_state_dict({k: paddle.to_tensor(v) for k, v in gpt_state.items()})
    t = paddle.to_tensor(IDS)
    loss = j(t, labels=t)
    loss.backward()
    want = float(np.sqrt(sum(float(jnp.sum(jnp.square(p.grad._value)))
                             for p in j.parameters())))
    for r_loss, norm in pool.run("pp_norm", _lm(gpt_state), IDS, CFG):
        np.testing.assert_allclose(r_loss, float(loss), rtol=1e-5)
        np.testing.assert_allclose(norm, want, rtol=1e-5)


# ------------------------------------------------- (10) the converter by stage
def test_converter_round_trip_by_stage(pool, gpt_state):
    """The reference pipe's dict loads by stage (each rank its blocks'
    mp shards and the replicas) and the export gathers it back byte for
    byte."""
    state = _lm(gpt_state)
    for r in pool.run("pp_convert", state, CFG):
        assert r["same"]
        assert all(not k.startswith("lm.gpt.layers.") or
                   int(k.split(".")[3]) in (0, 1, 2, 3) for k in r["own"])
        assert len([k for k in r["own"] if k.startswith("lm.gpt.layers.")]) \
            == 2 * 12


# ------------------------------------------------------------ the example
def test_train_gpt_hybrid_example_matches_one_process(pool):
    """``examples/train_gpt_hybrid.py`` at its defaults (dp 2 x pp 2 x
    mp 2, 11 steps with the untimed first) on the eight ranks: every
    rank's losses are the unsharded GPT's on the same 8-row batch."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              load_paddle_tpu_state_dict)

    argv = ["--device", "cpu"]
    res = pool.run("example", "train_gpt_hybrid", argv, timeout=300)
    # the example's logical starting weights (its vocab-parallel table is
    # drawn as the reference's, not as a plain Embedding's)
    init = pool.run("gpt_hybrid_example_init", argv)
    for other in init[1:]:
        for k in init[0]:
            np.testing.assert_array_equal(other[k], init[0][k])
    lm = GPTForCausalLM(vocab_size=512, hidden_size=64, num_hidden_layers=4,
                        num_attention_heads=4, max_position_embeddings=64,
                        device="cpu")
    load_paddle_tpu_state_dict(lm, init[0])
    step = jit.TrainStep(lm, topt.AdamW(learning_rate=3e-4,
                                        parameters=lm.parameters()))
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        1, 512, (8, 64)).astype("int64"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [float(step({"input_ids": ids, "labels": ids}))
                for _ in range(11)]
    for r in res:
        assert len(r["losses"]) == 11
        np.testing.assert_allclose(r["losses"], want, **GPT_TOL)
