"""The container half of ``nn.layer`` (counterpart of
``paddle_tpu/nn/layer.py``): ``Sequential``, ``LayerList``,
``ParameterList`` and ``LayerDict`` over ``torch.nn``'s containers.

Sub-layers keep paddle's names (``"0"``, ``"1"``, ... or the names given),
so state-dict keys equal the reference's.  ``Sequential`` also takes
``(name, layer)`` tuples, or one list of such pairs, as the reference
does.  ``nn.Layer`` itself and the eager tensor substrate are not ported:
a port layer is a ``torch.nn.Module``.
"""

from __future__ import annotations

import torch


class Sequential(torch.nn.Sequential):
    """Calls its sub-layers in order; ``Sequential(l0, l1)``,
    ``Sequential(("a", l0), ("b", l1))`` or
    ``Sequential([("a", l0), ("b", l1)])``."""

    def __init__(self, *layers):
        torch.nn.Module.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], dict):   # a slice
            for name, layer in layers[0].items():
                self.add_module(name, layer)
        elif len(layers) == 1 and isinstance(layers[0], (list, tuple)) and (
                len(layers[0]) == 0 or isinstance(layers[0][0], (list, tuple))):
            for name, layer in layers[0]:
                self.add_module(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_module(layer[0], layer[1])
                else:
                    self.add_module(str(i), layer)


class LayerList(torch.nn.ModuleList):
    """``torch.nn.ModuleList`` under paddle's name and argument
    (``sublayers``)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(torch.nn.ParameterList):
    def __init__(self, parameters=None):
        super().__init__(parameters)


class LayerDict(torch.nn.ModuleDict):
    """Ordered ``str -> layer`` container (``torch.nn.ModuleDict``)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
