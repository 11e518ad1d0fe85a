"""PyTorch port, slice 15's high-level side: ``hapi.Model`` (fit /
evaluate / predict, train / eval / predict_batch, save / load, summary),
the callbacks, ``metric``, ``io``, ``framework.io`` / ``framework.random``
and ``examples/finetune_bert.py``, on the CPU against the JAX package.

The same numpy data goes through both packages' ``Model`` with weights
carried across by ``load_paddle_tpu_state_dict``.  Tolerances: per-batch
trained losses rtol 1e-4 (atol 1e-6), as the f32 ``TrainStep`` gates;
forwards, ``predict`` outputs and logits after a load within 1e-5;
metric values within 1e-12 (the same numpy arithmetic) or 1e-6 where a
tensor op computes them; resumed training bit for bit.  The JAX
``DataLoader`` and ``MetricsLoggerCallback`` write the process-wide JAX
registry, and the port's its own: counters are compared as deltas."""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi import model_summary as jsummary
from paddle_tpu.text.models import bert as jbert
import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.examples import finetune_bert
from paddle_tpu_torch.framework import io as tfio
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.hapi import model_summary as tsummary
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.text.models import (ErnieForSequenceClassification,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parent.parent


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype("float32")
    y = (x.sum(axis=1) > 0).astype("int64")
    return x, y


class _JData(jio.Dataset):
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class _TData(tio.Dataset):
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def _nets(hidden=32, classes=2, seed=1):
    paddle.seed(seed)
    j = jnn.Sequential(jnn.Linear(8, hidden), jnn.ReLU(),
                       jnn.Linear(hidden, classes))
    t = torch.nn.Sequential(tnn.Linear(8, hidden), torch.nn.ReLU(),
                            tnn.Linear(hidden, classes))
    load_paddle_tpu_state_dict(t, _state(j))
    return j, t


def _models(metrics=True, lr=0.01, opt="Adam", amp_configs=None, **net_kw):
    j, t = _nets(**net_kw)
    jm, tm = paddle.Model(j), Model(t, device="cpu")
    jm.prepare(getattr(jopt, opt)(learning_rate=lr, parameters=j.parameters()),
               jnn.CrossEntropyLoss(),
               jmetric.Accuracy() if metrics else None,
               amp_configs=amp_configs)
    tm.prepare(getattr(topt, opt)(learning_rate=lr, parameters=t.parameters()),
               tnn.CrossEntropyLoss(),
               tmetric.Accuracy() if metrics else None,
               amp_configs=amp_configs)
    return jm, tm


def _recorder(base):
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.batches, self.epochs, self.evals = [], [], []

        def on_train_batch_end(self, step, logs=None):
            self.batches.append(dict(logs))

        def on_epoch_end(self, epoch, logs=None):
            self.epochs.append(epoch)

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs or {}))
    return Rec()


def _assert_logs(tl, jl, tol=LOSS_TOL):
    assert len(tl) == len(jl) and len(tl) > 0
    for a, b in zip(tl, jl):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **tol, err_msg=k)


# ================================================================= Model
@pytest.mark.parametrize("shuffle", [False, True])
def test_fit_evaluate_predict_match_reference(shuffle):
    """Per-batch losses and running accuracy, the eval logs after each
    epoch, and ``predict`` (stacked) against the JAX ``Model``; shuffled
    epochs under one ``np.random.seed`` visit the same indices."""
    x, y = _data()
    jm, tm = _models()
    jr, tr = _recorder(jcb.Callback), _recorder(tcb.Callback)
    np.random.seed(0)
    jm.fit(_JData(x, y), eval_data=_JData(x[:32], y[:32]), epochs=2,
           batch_size=16, verbose=0, shuffle=shuffle, callbacks=[jr])
    np.random.seed(0)
    tm.fit(_TData(x, y), eval_data=_TData(x[:32], y[:32]), epochs=2,
           batch_size=16, verbose=0, shuffle=shuffle, callbacks=[tr])
    _assert_logs(tr.batches, jr.batches)
    _assert_logs(tr.evals, jr.evals)
    assert tr.epochs == jr.epochs == [0, 1]
    jl = jm.evaluate(_JData(x, y), batch_size=16, verbose=0)
    tl = tm.evaluate(_TData(x, y), batch_size=16, verbose=0)
    _assert_logs([tl], [jl], TOL)
    jp = jm.predict(_JData(x, y), batch_size=16, stack_outputs=True)
    tp = tm.predict(_TData(x, y), batch_size=16, stack_outputs=True)
    assert tp[0].shape == (64, 2)
    np.testing.assert_allclose(tp[0], np.asarray(jp[0]), **TOL)
    tp2 = tm.predict(_TData(x, y), batch_size=16)
    assert len(tp2[0]) == 4 and tp2[0][0].shape == (16, 2)


def test_fit_accumulate_num_iters_and_loader():
    """``accumulate_grad_batches=2`` (return_outputs off in both, so no
    metric rows) and ``num_iters`` stopping mid-epoch, fed through each
    package's DataLoader."""
    x, y = _data()
    for kw in ({"accumulate_grad_batches": 2}, {"num_iters": 3}):
        jm, tm = _models(metrics=False)
        jr, tr = _recorder(jcb.Callback), _recorder(tcb.Callback)
        jm.fit(jio.DataLoader(_JData(x, y), batch_size=16), epochs=2,
               verbose=0, callbacks=[jr], **kw)
        tm.fit(tio.DataLoader(_TData(x, y), batch_size=16), epochs=2,
               verbose=0, callbacks=[tr], **kw)
        _assert_logs(tr.batches, jr.batches)
        assert tr.epochs == jr.epochs
        assert tm._train_step.accumulate_steps == \
            jm._train_step.accumulate_steps
        assert tm.stop_training == jm.stop_training


def test_train_eval_predict_batch():
    jm, tm = _models()
    x = np.random.RandomState(0).randn(8, 8).astype("float32")
    y = np.random.RandomState(1).randint(0, 2, (8,)).astype("int64")
    for _ in range(2):
        np.testing.assert_allclose(tm.train_batch([x], [y]),
                                   jm.train_batch([x], [y]), **LOSS_TOL)
    np.testing.assert_allclose(tm.eval_batch([x], [y]), jm.eval_batch([x], [y]),
                               **TOL)
    np.testing.assert_allclose(tm.predict_batch([x])[0],
                               np.asarray(jm.predict_batch([x])[0]), **TOL)
    assert tm.network.training           # flag put back after eval_batch
    # labels as [B, 1]: the loss and the metric read them the same way
    np.testing.assert_allclose(tm.train_batch([x], [y[:, None]]),
                               jm.train_batch([x], [y[:, None]]), **LOSS_TOL)
    assert tm._metrics[0].accumulate() == jm._metrics[0].accumulate()


def test_fp16_amp_configs_scaler_trajectory():
    """``amp_configs`` with float16 builds the GradScaler from the
    reference's knobs; a scale large enough to overflow float16 halves on
    each bad step and then grows every 2 good ones: the trajectory of
    ``loss_scale`` and the losses equal the reference's."""
    cfg = {"level": "O2", "dtype": "float16", "init_loss_scaling": 2.0 ** 24,
           "incr_every_n_steps": 2, "decr_every_n_nan_or_inf": 1}
    jm, tm = _models(metrics=False, opt="AdamW", lr=1e-3, amp_configs=cfg,
                     classes=4)
    x = np.random.RandomState(0).randn(16, 8).astype("float32") * 4
    y = np.random.RandomState(1).randint(0, 4, (16,)).astype("int64")
    traj = {"jax": [], "torch": []}
    losses = {"jax": [], "torch": []}
    for name, m in (("jax", jm), ("torch", tm)):
        for _ in range(12):
            losses[name].append(m.train_batch([x], [y])[0])
            traj[name].append(m._train_step.loss_scale)
    assert tm._train_step._scaler is not None
    assert traj["torch"] == traj["jax"]
    assert min(traj["torch"]) < 2.0 ** 24      # it did overflow and back off
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=2e-3)
    # a plain string keeps no scaler
    tm.prepare(tm._optimizer, tm._loss, amp_configs="O1")
    assert tm._scaler is None and tm._amp_level == "O1"


def test_save_load_across_packages(tmp_path):
    """A ``.pdparams`` written by the JAX ``Model.save`` loads into the
    port's ``Model.load`` and gives the same logits, and the reverse."""
    x, y = _data()
    jm, tm = _models()
    jm.fit(_JData(x, y), epochs=1, batch_size=16, verbose=0, shuffle=False)
    jm.save(str(tmp_path / "jax" / "ckpt"))
    _, fresh = _models(seed=5)
    fresh.load(str(tmp_path / "jax" / "ckpt"), reset_optimizer=True)
    np.testing.assert_allclose(fresh.predict_batch([x])[0],
                               np.asarray(jm.predict_batch([x])[0]), **TOL)
    tm.fit(_TData(x, y), epochs=2, batch_size=16, verbose=0, shuffle=False)
    tm.save(str(tmp_path / "torch" / "ckpt"))
    assert (tmp_path / "torch" / "ckpt.pdopt").exists()
    jfresh, _ = _models(seed=6)
    jfresh.load(str(tmp_path / "torch" / "ckpt"), reset_optimizer=True)
    np.testing.assert_allclose(np.asarray(jfresh.predict_batch([x])[0]),
                               tm.predict_batch([x])[0], **TOL)
    with pytest.raises(NotImplementedError, match="inference export"):
        tm.save(str(tmp_path / "torch" / "infer"), training=False)


def test_bert_tiny_save_load_across_packages(tmp_path):
    """BERT-tiny's state names and layouts through ``Model.save`` /
    ``load`` both ways (the tied MLM head once, under the embedding's
    name): JAX -> port and port -> JAX give the same logits (1e-5)."""
    cfg = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64,
               max_position_embeddings=32)
    ids = np.random.RandomState(0).randint(1, 64, (3, 12)).astype("int64")
    ids[1, 6:] = 0
    for jcls, tcls in ((jbert.BertForSequenceClassification,
                        ptt.text.BertForSequenceClassification),
                       (jbert.BertForPretraining,
                        ptt.text.BertForPretraining)):
        paddle.seed(0)
        # eval mode before the JAX Model's first predict_batch: its jitted
        # forward is cached per input shape with the sub-layers' training
        # flags of its first call (dropouts on in train mode)
        jm = paddle.Model(jcls(**cfg).eval())
        jm.save(str(tmp_path / "j"))
        tm = Model(tcls(device="cpu", **cfg), device="cpu")
        tm.load(str(tmp_path / "j"))
        for a, b in zip(tm.predict_batch([ids]), jm.predict_batch([ids])):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
        with torch.no_grad():
            for p in tm.network.parameters():
                p.mul_(1.01)
        tm.save(str(tmp_path / "t"))
        jm.load(str(tmp_path / "t"), reset_optimizer=True)
        for a, b in zip(tm.predict_batch([ids]), jm.predict_batch([ids])):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_save_load_resume_is_bit_exact(tmp_path):
    """fit 2 epochs, save, load into a fresh model and optimizer, fit 2
    more: the weights and losses equal 4 uninterrupted epochs bit for bit
    (f32, CPU), the LR schedule's state included."""
    x, y = _data()

    def make():
        _, t = _nets()
        m = Model(t, device="cpu")
        sched = topt.lr.StepDecay(0.01, step_size=1, gamma=0.5)
        m.prepare(topt.AdamW(learning_rate=sched, parameters=t.parameters()),
                  tnn.CrossEntropyLoss(), tmetric.Accuracy())
        return m

    whole, rw = make(), _recorder(tcb.Callback)
    whole.fit(_TData(x, y), epochs=4, batch_size=16, verbose=0,
              shuffle=False, callbacks=[rw])
    first, r1 = make(), _recorder(tcb.Callback)
    first.fit(_TData(x, y), epochs=2, batch_size=16, verbose=0,
              shuffle=False, callbacks=[r1])
    first.save(str(tmp_path / "ckpt"))
    second, r2 = make(), _recorder(tcb.Callback)
    with torch.no_grad():
        for p in second.network.parameters():
            p.mul_(0.5)
    second.load(str(tmp_path / "ckpt"))
    second.fit(_TData(x, y), epochs=2, batch_size=16, verbose=0,
               shuffle=False, callbacks=[r2])
    assert [b["loss"] for b in r1.batches + r2.batches] == \
        [b["loss"] for b in rw.batches]
    for a, b in zip(second.network.parameters(), whole.network.parameters()):
        assert torch.equal(a, b)
    assert second._optimizer.get_lr() == whole._optimizer.get_lr()


# ============================================================ callbacks
def test_early_stopping_same_epoch():
    x, y = _data()
    stops = {}
    for name, (m, cb_mod, data) in {
            "jax": (_models(lr=0.05)[0], jcb, _JData),
            "torch": (_models(lr=0.05)[1], tcb, _TData)}.items():
        es = cb_mod.EarlyStopping(monitor="loss", patience=1, verbose=0,
                                  min_delta=0.02)
        rec = _recorder(cb_mod.Callback)
        m.fit(data(x, y), eval_data=data(x[:16], y[:16]), epochs=10,
              batch_size=16, verbose=0, shuffle=False, callbacks=[es, rec])
        stops[name] = (rec.epochs, es.best, es.wait, m.stop_training)
    assert stops["torch"][0] == stops["jax"][0]
    assert len(stops["torch"][0]) < 10                  # it did stop
    np.testing.assert_allclose(stops["torch"][1], stops["jax"][1], **LOSS_TOL)
    assert stops["torch"][2:] == stops["jax"][2:]


def test_reduce_lr_on_plateau_and_lr_scheduler_trajectories():
    x, y = _data()
    lrs = {}
    for name, (m, cb_mod, data) in {
            "jax": (_models(lr=0.05)[0], jcb, _JData),
            "torch": (_models(lr=0.05)[1], tcb, _TData)}.items():
        plateau = cb_mod.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                           patience=1, verbose=0,
                                           min_delta=0.05, cooldown=1)

        class Lr(cb_mod.Callback):
            seen = []

            def on_epoch_begin(self, epoch, logs=None):
                self.seen.append(self.model._optimizer.get_lr())
        lr = Lr()
        lr.seen = []
        m.fit(data(x, y), eval_data=data(x[:16], y[:16]), epochs=8,
              batch_size=32, verbose=0, shuffle=False, callbacks=[plateau, lr])
        lrs[name] = lr.seen
    assert lrs["torch"] == lrs["jax"]
    assert min(lrs["torch"]) < 0.05
    # LRScheduler by step and by epoch over a StepDecay
    for by_step in (True, False):
        seen = {}
        for name, (pkg_opt, model_cls, cb_mod, data, net) in {
                "jax": (jopt, paddle.Model, jcb, _JData, _nets()[0]),
                "torch": (topt, functools.partial(Model, device="cpu"), tcb,
                          _TData, _nets()[1])}.items():
            sched = pkg_opt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
            m = model_cls(net)
            m.prepare(pkg_opt.SGD(learning_rate=sched,
                                  parameters=net.parameters()),
                      jnn.CrossEntropyLoss() if name == "jax"
                      else tnn.CrossEntropyLoss())
            m.fit(data(x, y), epochs=3, batch_size=16, verbose=0,
                  shuffle=False,
                  callbacks=[cb_mod.LRScheduler(by_step=by_step)])
            seen[name] = (sched.last_epoch, sched())
        assert seen["torch"] == seen["jax"]


def test_model_checkpoint_files_load_in_both(tmp_path):
    x, y = _data()
    jm, tm = _models()
    jm.fit(_JData(x, y), epochs=2, batch_size=16, verbose=0, shuffle=False,
           save_dir=str(tmp_path / "jax"))
    tm.fit(_TData(x, y), epochs=2, batch_size=16, verbose=0, shuffle=False,
           save_dir=str(tmp_path / "torch"))
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert "final.pdparams" in names and "0.pdparams" in names
    for tag in ("0", "final"):
        jr, _ = _models(seed=7)
        _, tr = _models(seed=8)
        jr.load(str(tmp_path / "torch" / tag), reset_optimizer=True)
        tr.load(str(tmp_path / "jax" / tag), reset_optimizer=True)
        np.testing.assert_allclose(tr.predict_batch([x])[0],
                                   np.asarray(jr.predict_batch([x])[0]),
                                   **LOSS_TOL)


def test_visualdl_scalars_match(tmp_path):
    x, y = _data()
    jm, tm = _models()
    jm.fit(_JData(x, y), eval_data=_JData(x, y), epochs=2, batch_size=16,
           verbose=0, shuffle=False,
           callbacks=[jcb.VisualDL(str(tmp_path / "jax"))])
    tm.fit(_TData(x, y), eval_data=_TData(x, y), epochs=2, batch_size=16,
           verbose=0, shuffle=False,
           callbacks=[tcb.VisualDL(str(tmp_path / "torch"))])

    def rows(d):
        with open(d / "scalars.jsonl") as f:
            return [json.loads(line) for line in f]
    jr, tr = rows(tmp_path / "jax"), rows(tmp_path / "torch")
    assert [(r["tag"], r["step"]) for r in tr] == \
        [(r["tag"], r["step"]) for r in jr]
    np.testing.assert_allclose([r["value"] for r in tr],
                               [r["value"] for r in jr], **LOSS_TOL)
    assert any(p.name.startswith("events.out.tfevents")
               for p in (tmp_path / "torch").iterdir())


def test_prog_bar_metrics_logger_and_wandb(tmp_path, capsys):
    x, y = _data()
    _, tm = _models()
    reg = tmetrics.get_registry()
    before = reg.counter("dataloader.batches").total()
    tm.fit(_TData(x, y), epochs=1, batch_size=16, verbose=2, shuffle=False,
           callbacks=[tcb.MetricsLoggerCallback(log_dir=str(tmp_path),
                                                verbose=0)])
    out = capsys.readouterr().out
    assert "Epoch 1/1" in out and "step 0/4" in out and "acc:" in out
    row = json.loads((tmp_path / "train_metrics.jsonl").read_text()
                     .splitlines()[0])
    assert row["steps"] == 4 and row["dataloader.batches"] == 4.0
    assert row["train_step.compiles"] == 1.0
    assert reg.counter("dataloader.batches").total() - before == 4
    assert (tmp_path / "metrics.prom").exists()
    with pytest.raises(ImportError, match="wandb"):
        tcb.WandbCallback(project="p")
    assert set(ptt.callbacks.__dict__) >= {"EarlyStopping", "VisualDL",
                                           "ReduceLROnPlateau"}


# ============================================================ summary
def test_summary_and_flops_totals(capsys):
    j, t = _nets()
    js = jsummary.summary(j, (4, 8))
    jtable = capsys.readouterr().out
    ts = tsummary.summary(t, (4, 8))
    ttable = capsys.readouterr().out
    assert ts == js
    # the same rows, save the layer types' names (ReLU is torch's here)
    assert [r.split()[0] for r in ttable.splitlines()] == \
        [r.split()[0] for r in jtable.splitlines()]
    assert ttable.count("288") == jtable.count("288")
    for size in ([4, 8], [3, 5, 8]):
        assert tsummary.flops(t, size) == jsummary.flops(j, size)
    jt = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 3))
    tt = torch.nn.Sequential(tnn.Linear(8, 16), torch.nn.Tanh(),
                             tnn.Linear(16, 3))
    assert tsummary.flops(tt, [4, 8]) == jsummary.flops(jt, [4, 8])
    # BERT: parameter totals through Model.summary with int64 ids
    paddle.seed(0)
    jb = jbert.BertForSequenceClassification(
        vocab_size=64, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=16)
    tb = ptt.text.BertForSequenceClassification(
        vocab_size=64, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=16, device="cpu")
    assert Model(tb, device="cpu").summary((2, 8), "int64") == \
        paddle.Model(jb).summary((2, 8), "int64")


# ============================================================ metric
def test_metrics_match_reference():
    rs = np.random.RandomState(0)
    logits = rs.randn(50, 5).astype("float32")
    labels = rs.randint(0, 5, (50, 1)).astype("int64")
    for topk in (1, (1, 3)):
        jm, tm = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
        for sl in (slice(0, 20), slice(20, 50)):
            jc = jm.compute(paddle.to_tensor(logits[sl]),
                            paddle.to_tensor(labels[sl]))
            tc = tm.compute(torch.from_numpy(logits[sl]),
                            torch.from_numpy(labels[sl]))
            np.testing.assert_array_equal(tc, np.asarray(jc._value))
            np.testing.assert_array_equal(tm.update(tc), jm.update(jc))
        assert tm.accumulate() == jm.accumulate()
        assert tm.name() == jm.name()
    probs = rs.rand(200).astype("float32")
    bins = rs.randint(0, 2, 200).astype("int64")
    for cls in ("Precision", "Recall", "Auc"):
        jm, tm = getattr(jmetric, cls)(), getattr(tmetric, cls)()
        for sl in (slice(0, 120), slice(120, 200)):
            jm.update(probs[sl], bins[sl])
            tm.update(torch.from_numpy(probs[sl]), torch.from_numpy(bins[sl]))
        assert abs(tm.accumulate() - jm.accumulate()) <= 1e-12
        assert tm.name() == jm.name()
    two = np.stack([1 - probs, probs], 1)
    ja, ta = jmetric.Auc(num_thresholds=255), tmetric.Auc(num_thresholds=255)
    ja.update(two, bins)
    ta.update(torch.from_numpy(two), torch.from_numpy(bins))
    assert ta.accumulate() == ja.accumulate()
    for k in (1, 2):
        np.testing.assert_allclose(
            float(tmetric.accuracy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), k=k)),
            float(np.asarray(jmetric.accuracy(paddle.to_tensor(logits),
                                              paddle.to_tensor(labels),
                                              k=k)._value)), atol=1e-6)


def test_detection_map_matches_reference():
    rs = np.random.RandomState(1)
    for map_type in ("11point", "integral"):
        jm = jmetric.DetectionMAP(3, map_type=map_type)
        tm = tmetric.DetectionMAP(3, map_type=map_type)
        for _ in range(4):
            gt = rs.rand(5, 4) * 50
            gt[:, 2:] += gt[:, :2] + 5
            gl = rs.randint(-1, 3, 5)
            det = gt + rs.randn(5, 4) * 3
            sc, dl = rs.rand(5), rs.randint(0, 3, 5)
            diff = rs.rand(5) < 0.2
            jm.update(det, sc, dl, gt, gl, gt_difficult=diff)
            tm.update(torch.from_numpy(det), torch.from_numpy(sc),
                      torch.from_numpy(dl), gt, gl, gt_difficult=diff)
        assert tm.accumulate() == jm.accumulate()


# ================================================================== io
def test_samplers_and_splits_match_reference():
    data = list(range(23))
    for seed in (0, 3):
        np.random.seed(seed)
        jb = list(jio.BatchSampler(data, shuffle=True, batch_size=5))
        np.random.seed(seed)
        tb = list(tio.BatchSampler(data, shuffle=True, batch_size=5))
        assert tb == jb
    for drop_last in (False, True):
        for nr in (1, 3, 4):
            for rank in range(nr):
                for shuffle in (False, True):
                    j = jio.DistributedBatchSampler(data, 4, nr, rank,
                                                    shuffle, drop_last)
                    t = tio.DistributedBatchSampler(data, 4, nr, rank,
                                                    shuffle, drop_last)
                    j.set_epoch(2), t.set_epoch(2)
                    assert list(t) == list(j) and len(t) == len(j)
    t = tio.DistributedBatchSampler(data, 4)     # no process group: 1 / 0
    assert (t.nranks, t.local_rank) == (1, 0)
    import torch.distributed as dist

    saved = dist.is_initialized, dist.get_world_size, dist.get_rank
    dist.is_initialized = lambda: True           # a group of 3, rank 1
    dist.get_world_size, dist.get_rank = (lambda: 3), (lambda: 1)
    try:
        t = tio.DistributedBatchSampler(data, 4, shuffle=True)
    finally:
        dist.is_initialized, dist.get_world_size, dist.get_rank = saved
    assert (t.nranks, t.local_rank) == (3, 1)
    assert list(t) == list(jio.DistributedBatchSampler(data, 4, 3, 1, True))
    np.random.seed(4)
    js = jio.random_split(data, [0.5, 0.3, 0.2])
    np.random.seed(4)
    ts = tio.random_split(data, [0.5, 0.3, 0.2])
    assert [list(s) for s in ts] == [list(s) for s in js]
    np.random.seed(5)
    jw = list(jio.WeightedRandomSampler([0.1, 0.5, 0.4], 20))
    np.random.seed(5)
    assert list(tio.WeightedRandomSampler([0.1, 0.5, 0.4], 20)) == jw
    np.random.seed(6)
    jr = list(jio.RandomSampler(data, replacement=True, num_samples=9))
    np.random.seed(6)
    assert list(tio.RandomSampler(data, replacement=True, num_samples=9)) == jr


class _Range(tio.IterableDataset):
    def __iter__(self):
        return iter(np.arange(10, dtype="float32"))


class _WorkerTag(tio.Dataset):
    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.array([i, -1 if info is None else info.id], "int64")

    def __len__(self):
        return 12


def test_datasets_and_collate():
    x, y = _data(10)
    tds = tio.TensorDataset([torch.from_numpy(x), y])
    jds = jio.TensorDataset([x, y])
    assert len(tds) == len(jds) == 10
    np.testing.assert_array_equal(tds[3][0], jds[3][0])
    comp = tio.ComposeDataset([tds, tio.TensorDataset([y])])
    assert len(comp) == 10 and len(comp[2]) == 3
    cat = tio.ConcatDataset([tds, tio.Subset(tds, [1, 2])])
    jcat = jio.ConcatDataset([jds, jio.Subset(jds, [1, 2])])
    assert len(cat) == len(jcat) == 12
    np.testing.assert_array_equal(cat[11][0], jcat[11][0])
    np.testing.assert_array_equal(cat[-1][0], jcat[-1][0])
    assert [int(v) for v in tio.ChainDataset([_Range(), _Range()])][-1] == 9
    batch = tio.default_collate_fn([{"a": torch.ones(2), "b": (1, 2.0)},
                                    {"a": torch.zeros(2), "b": (3, 4.0)}])
    assert batch["a"].shape == (2, 2) and batch["b"][0].tolist() == [1, 3]
    with pytest.raises(TypeError):
        len(tio.DataLoader(_Range()))
    assert [b.tolist() for b in tio.DataLoader(_Range(), batch_size=4,
                                               drop_last=True)] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("workers,mode", [(0, "thread"), (2, "thread"),
                                          (2, "process")])
def test_dataloader_batches_match_reference(workers, mode):
    """Batches in order, as torch tensors, equal the reference loader's;
    process workers see their ``get_worker_info``; the port's
    ``dataloader.*`` counters move by the batches yielded."""
    x, y = _data(37)
    reg = tmetrics.get_registry()
    before = reg.counter("dataloader.batches").total()
    np.random.seed(1)
    jb = list(jio.DataLoader(_JData(x, y), batch_size=8, shuffle=True,
                             num_workers=workers, worker_mode=mode))
    np.random.seed(1)
    loader = tio.DataLoader(_TData(x, y), batch_size=8, shuffle=True,
                            num_workers=workers, worker_mode=mode)
    tb = list(loader)
    assert len(tb) == len(jb) == len(loader) == 5
    for (tx, ty), (jx, jy) in zip(tb, jb):
        assert isinstance(tx, torch.Tensor) and tx.dtype == torch.float32
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx._value))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy._value))
    assert reg.counter("dataloader.batches").total() - before == 5
    assert reg.counter("dataloader.host_wait_seconds").total() > 0
    tags = np.concatenate([b.numpy() for b in tio.DataLoader(
        _WorkerTag(), batch_size=3, num_workers=workers, worker_mode=mode)])
    assert tags[:, 0].tolist() == list(range(12))
    want = {0, 1} if mode == "process" and workers else {-1}
    assert set(tags[:, 1].tolist()) == want
    assert tio.get_worker_info() is None


# ================================================== framework io / random
def test_pdparams_schema_both_ways(tmp_path):
    """Tensors of every dtype the models hold, bf16 as its uint16 bit
    pattern: a file written by either package reads back equal in the
    other."""
    from paddle_tpu.framework import io as jfio

    rs = np.random.RandomState(0)
    f32 = rs.randn(3, 4).astype("float32")
    i64 = rs.randint(0, 9, (5,)).astype("int64")
    bf = torch.from_numpy(rs.randn(6).astype("float32")).bfloat16()
    tfio.save({"w": torch.nn.Parameter(torch.from_numpy(f32)),
               "ids": torch.from_numpy(i64), "bf": bf, "step": 3,
               "nested": [torch.ones(2), {"x": 1.5}]},
              str(tmp_path / "t.pdparams"))
    back = jfio.load(str(tmp_path / "t.pdparams"))
    np.testing.assert_array_equal(np.asarray(back["w"]._value), f32)
    np.testing.assert_array_equal(np.asarray(back["ids"]._value), i64)
    np.testing.assert_array_equal(
        np.asarray(back["bf"]._value).astype("float32"), bf.float().numpy())
    assert back["step"] == 3 and back["nested"][1] == {"x": 1.5}
    jfio.save(back, str(tmp_path / "j.pdparams"))
    again = tfio.load(str(tmp_path / "j.pdparams"))
    assert isinstance(again["w"], torch.nn.Parameter)
    assert not isinstance(again["ids"], torch.nn.Parameter)
    assert again["bf"].dtype == torch.bfloat16 and torch.equal(again["bf"], bf)
    np.testing.assert_array_equal(again["w"].detach().numpy(), f32)
    assert again["ids"].dtype == torch.int64
    arrs = tfio.load(str(tmp_path / "j.pdparams"), return_numpy=True)
    assert isinstance(arrs["w"], np.ndarray) and arrs["bf"].dtype == np.float32
    assert ptt.save is tfio.save and ptt.load is tfio.load


def test_bf16_model_save_keeps_dtype(tmp_path):
    from paddle_tpu.framework import io as jfio

    _, t = _nets()
    t = t.to(torch.bfloat16)
    m = Model(t, device="cpu")
    m.save(str(tmp_path / "bf"))
    j = jfio.load(str(tmp_path / "bf.pdparams"))
    assert str(j["0.weight"]._value.dtype) == "bfloat16"
    assert tuple(j["0.weight"].shape) == (8, 32)       # paddle's [in, out]
    _, t2 = _nets(seed=3)
    Model(t2.to(torch.bfloat16), device="cpu").load(str(tmp_path / "bf"))
    for a, b in zip(t.parameters(), t2.parameters()):
        assert torch.equal(a, b)


def test_seed_reproduces_weights_and_host_draws():
    from paddle_tpu_torch.framework import random as trandom

    ptt.seed(11)
    a = tnn.Linear(4, 4).weight.detach().clone()
    u = trandom.host_uniform()
    ptt.seed(11)
    assert torch.equal(tnn.Linear(4, 4).weight, a)
    assert trandom.host_uniform() == u and trandom.get_seed() == 11


def test_new_modules_import_no_jax():
    """A fresh interpreter imports every module of the slice (and runs a
    BERT forward) without loading JAX."""
    code = (
        "import sys, torch\n"
        "import paddle_tpu_torch as p\n"
        "from paddle_tpu_torch import hapi, callbacks, io, metric, nn\n"
        "from paddle_tpu_torch.framework import io as fio, random\n"
        "from paddle_tpu_torch.nn import initializer\n"
        "from paddle_tpu_torch.nn.layers import transformer\n"
        "from paddle_tpu_torch.text import tokenizer, models\n"
        "from paddle_tpu_torch.utils import summary_writer, _tfevents\n"
        "from paddle_tpu_torch.examples import finetune_bert\n"
        "m = models.BertModel(vocab_size=16, hidden_size=8,"
        " num_hidden_layers=1, num_attention_heads=2, intermediate_size=8,"
        " device='cpu')\n"
        "m(torch.ones(1, 4, dtype=torch.long))\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'paddle_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(ROOT),
                   env=env, timeout=120)


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.text.BertModel(vocab_size=16, hidden_size=8, num_hidden_layers=1,
                           num_attention_heads=2, intermediate_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.Transformer.generate_square_subsequent_mask(3)


def test_model_places_its_network(monkeypatch):
    """``Model`` runs its network on the card unless ``device="cpu"`` is
    asked for: a CPU network given no device raises without a card (it
    never trains on the CPU unasked); asked, the network and its batches
    stay on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t = _nets()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(torch.nn.ReLU())          # no parameters: the card all the same
    m = Model(t, device="cpu")
    assert m.network is t and m._device.type == "cpu"
    assert m._to_tensors(np.ones((2, 8), "float32"))[0].device.type == "cpu"


# ============================================================ example
def test_finetune_bert_example_matches_reference():
    """The example's recipe at its toy size with every dropout at 0: one
    epoch's per-batch losses (shuffled under one ``np.random.seed``) and
    the final evaluation equal the JAX ``Model`` over the same weights."""
    ids, labels, vocab = finetune_bert.build_data()
    t = finetune_bert.build_model("ernie", vocab, 32, dropout=0.0,
                                  device="cpu")
    assert isinstance(t, ErnieForSequenceClassification)
    paddle.seed(0)
    j = jbert.ErnieForSequenceClassification(
        num_classes=2, vocab_size=vocab, hidden_size=128,
        num_hidden_layers=4, num_attention_heads=4, intermediate_size=256,
        max_position_embeddings=32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, dropout=0.0)
    load_paddle_tpu_state_dict(t, _state(j))
    tr = _recorder(tcb.Callback)
    np.random.seed(0)
    _, tlogs = finetune_bert.finetune(t, ids, labels, epochs=1, verbose=0,
                                      callbacks=[tr], device="cpu")
    jm = paddle.Model(j)
    jm.prepare(jopt.AdamW(learning_rate=5e-4, parameters=j.parameters()),
               jnn.CrossEntropyLoss(), jmetric.Accuracy())
    jr = _recorder(jcb.Callback)
    np.random.seed(0)
    jm.fit(jio.TensorDataset([ids, labels]), epochs=1, batch_size=16,
           verbose=0, callbacks=[jr])
    jlogs = jm.evaluate(jio.TensorDataset([ids, labels]), batch_size=16,
                        verbose=0)
    _assert_logs(tr.batches, jr.batches)
    _assert_logs([tlogs], [jlogs])


def test_finetune_bert_main_on_cpu(capsys):
    logs = finetune_bert.main(["--device", "cpu", "--epochs", "1",
                               "--model", "bert"])
    assert np.isfinite(logs["loss"]) and 0.0 <= logs["acc"] <= 1.0
    assert "final:" in capsys.readouterr().out
