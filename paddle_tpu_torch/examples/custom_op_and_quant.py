"""Custom op + quantization-aware training, end to end (counterpart of
``examples/custom_op_and_quant.py``).

1. ``register_op`` installs the fused bias + GELU kernel (K6,
   ``ops/bias_gelu.py``: hand-written CUDA on the card, its plain version
   on the CPU) as ``paddle_tpu_torch.ops.fused_bias_gelu``, with the TPU
   package's gradient formula as its vjp;
2. ``quantization.QAT`` wraps the Linears with fake-quanters
   (straight-through gradients);
3. ``jit.TrainStep`` trains both, 30 steps of AdamW on one seeded batch,
   and ``extract_scales`` reads the calibrated scales.

Run: ``python -m paddle_tpu_torch.examples.custom_op_and_quant`` (on the
card), or with ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from paddle_tpu_torch import jit, ops, optimizer
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.custom_op import register_op
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear
from paddle_tpu_torch.ops.bias_gelu import bias_gelu, bias_gelu_bwd
from paddle_tpu_torch.quantization import QAT, QuantConfig, extract_scales
from paddle_tpu_torch.text.models import load_paddle_tpu_state_dict

register_op("fused_bias_gelu", bias_gelu, vjp=bias_gelu_bwd, override=True)


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Linear(32, 64, bias=False)
        self.b1 = torch.nn.Parameter(torch.zeros(64))   # paddle's is_bias init
        self.fc2 = Linear(64, 10)

    def forward(self, x):
        h = ops.fused_bias_gelu(self.fc1(x), self.b1)
        return self.fc2(h)


def main(device=None, steps=30, state=None):
    """Train the QAT-wrapped ``Net`` ``steps`` times on the seed-0 batch
    ``[128, 32]``; returns ``(losses, scales)``.  ``state`` (paddle names
    -> numpy arrays, e.g. the TPU package's wrapped ``Net``'s
    ``state_dict()``) replaces the seeded init."""
    device = resolve_device(device)
    torch.manual_seed(0)
    model = QAT(QuantConfig()).quantize(Net())
    if state is not None:
        load_paddle_tpu_state_dict(model, state)
    model.to(device)
    opt = optimizer.AdamW(learning_rate=3e-3, parameters=model.parameters())
    step = jit.TrainStep(model, opt, loss_fn=CrossEntropyLoss())
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(128, 32).astype("float32")).to(device)
    y = torch.from_numpy(rs.randint(0, 10, (128,)).astype("int64")).to(device)
    losses = [step(x, y) for _ in range(steps)]
    return [float(l) for l in losses], extract_scales(model)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="QAT through a custom op")
    ap.add_argument("--device", default=None)
    losses, scales = main(ap.parse_args().device)
    for i in range(0, len(losses), 10):
        print(f"step {i:3d} loss {losses[i]:.4f}")
    print(f"final loss {losses[-1]:.4f}")
    print(f"{len(scales)} calibrated quant scales, e.g.",
          dict(list(scales.items())[:2]))
