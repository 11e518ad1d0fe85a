"""Common layers (counterpart of ``paddle_tpu/nn/layers/common.py``).

``Embedding`` and ``Dropout`` are ``torch.nn``'s own (paddle's defaults
match them).  ``Linear`` keeps torch's ``[out, in]`` weight; paddle stores
``[in, out]``, and ``text.models.convert`` transposes on load.
"""

from __future__ import annotations

import torch

from ... import amp


class Linear(torch.nn.Linear):
    """``y = x W^T + b``; weights Xavier-uniform and bias zero, as paddle's
    defaults.  Under ``amp.auto_cast`` it runs in the amp dtype (white
    list)."""

    def forward(self, x):
        return torch.nn.functional.linear(*amp.cast("linear", x, self.weight,
                                                    self.bias))

    def reset_parameters(self):
        torch.nn.init.xavier_uniform_(self.weight)
        if self.bias is not None:
            torch.nn.init.zeros_(self.bias)
