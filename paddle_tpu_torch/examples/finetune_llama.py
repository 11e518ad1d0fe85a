"""Llama fine-tuning, end to end (counterpart of
``examples/finetune_llama.py``): ``jit.TrainStep`` at O2 with gradient
accumulation, AdamW with the global-norm clip under a cosine schedule, a
``GradScaler`` for float16, an EMA of the weights updated every step, and
greedy / top-p ``generate()`` under ``ema.apply()`` at the end.

The corpus is synthetic (a next-token objective over random sequences
from ``numpy.RandomState(0)``), the config tiny by default.
:func:`finetune` takes a Llama model and the run's parameters,
so a caller can run it at any width; :func:`main` parses the reference's
flags.  Runs on the card by default:

    python -m paddle_tpu_torch.examples.finetune_llama [--steps 30]
        [--accum 2] [--hidden 256] [--layers 4]
        [--amp-dtype bfloat16|float16|float32] [--device cpu]

``--amp-dtype float32`` (not in the reference's choices) turns AMP off:
the f32 run is what a CPU reference is held to.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from paddle_tpu_torch import amp, jit
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.incubate.optimizer import ExponentialMovingAverage
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM


def tiny_config(hidden=256, layers=4, heads=8, kv_heads=4, vocab=2048,
                seq_len=128):
    """The reference example's config at its flags."""
    return LlamaConfig(
        vocab_size=vocab, hidden_size=hidden,
        intermediate_size=int(hidden * 8 / 3) // 16 * 16,
        num_hidden_layers=layers, num_attention_heads=heads,
        num_key_value_heads=kv_heads, max_position_embeddings=4 * seq_len,
        tie_word_embeddings=True)


def finetune(model, steps=30, batch_size=8, seq_len=128, accum=2, lr=3e-4,
             amp_dtype="bfloat16", ema_decay=0.99, new_tokens=16,
             log=print, on_step=None):
    """Run the recipe on ``model`` (a :class:`LlamaForCausalLM`, trained in
    place on its device).  ``amp_dtype`` None / ``"float32"`` trains in
    f32; ``on_step(i, loss)`` sees each step's 0-d loss tensor (read it
    only where a host sync is fine).  Returns the losses (floats), the
    EMA, the greedy and the sampled ids and the timing."""
    vocab = model.llama.config.vocab_size
    device = next(model.parameters()).device
    f32 = amp_dtype in (None, "float32")
    sched = opt.lr.CosineAnnealingDecay(learning_rate=lr, T_max=steps)
    optimizer = opt.AdamW(learning_rate=sched,
                          parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=opt.ClipGradByGlobalNorm(1.0))
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15) \
        if amp_dtype == "float16" else None
    step = jit.TrainStep(model, optimizer,
                         amp_level=None if f32 else "O2",
                         amp_dtype="bfloat16" if f32 else amp_dtype,
                         accumulate_steps=accum, scaler=scaler)
    ema = ExponentialMovingAverage(model, decay=ema_decay)

    rs = np.random.RandomState(0)
    model.train()
    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(steps):
        ids = torch.from_numpy(rs.randint(1, vocab, (batch_size, seq_len)))
        loss = step({"input_ids": ids, "labels": ids})
        ema.update()
        sched.step()
        losses.append(loss)
        if on_step is not None:
            on_step(i, loss)
        if log is not None and (i % 5 == 0 or i == steps - 1):
            extra = f" scale={step.loss_scale:.0f}" if scaler else ""
            log(f"step {i:4d}  loss {float(loss):.4f}  "
                f"lr {sched.get_lr():.2e}{extra}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    step.sync()
    losses = [float(x) for x in losses]
    tok_s = steps * batch_size * seq_len / dt
    if log is not None:
        log(f"{dt:.1f}s total, {tok_s:,.0f} tokens/s")

    # evaluate with the EMA weights, then generate
    with ema.apply():
        model.eval()
        prompt = rs.randint(1, vocab, (1, 8))
        greedy = model.generate(prompt, max_new_tokens=new_tokens,
                                temperature=0.0)
        sampled = model.generate(prompt, max_new_tokens=new_tokens,
                                 temperature=0.8, top_p=0.9, seed=1)
    greedy = greedy.cpu().numpy()[0, -new_tokens:].tolist()
    sampled = sampled.cpu().numpy()[0, -new_tokens:].tolist()
    if log is not None:
        log(f"greedy : {greedy}")
        log(f"sampled: {sampled}")
    return {"losses": losses, "ema": ema, "greedy": greedy,
            "sampled": sampled, "seconds": dt, "tokens_per_s": tok_s,
            "train_step": step, "prompt": prompt.tolist()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--amp-dtype", default="bfloat16",
                    choices=["bfloat16", "float16", "float32"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = tiny_config(args.hidden, args.layers, args.heads, args.kv_heads,
                      args.vocab, args.seq_len)
    gen = torch.Generator(device=args.device or "cuda").manual_seed(0)
    model = LlamaForCausalLM(cfg, device=args.device, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama: {n_params / 1e6:.1f}M params (GQA {args.heads}q/"
          f"{args.kv_heads}kv, SwiGLU, tied head)")
    finetune(model, steps=args.steps, batch_size=args.batch_size,
             seq_len=args.seq_len, accum=args.accum, lr=args.lr,
             amp_dtype=args.amp_dtype)


if __name__ == "__main__":
    main()
