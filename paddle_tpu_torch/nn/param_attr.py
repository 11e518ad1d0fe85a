"""``ParamAttr`` and the regularizers (counterpart of
``paddle_tpu/nn/param_attr.py``).  A layer reads ``attr.initializer`` when
it draws a parameter (:func:`.layers.common.make_parameter`, ``Linear``'s
``weight_attr`` / ``bias_attr``); the regularizers' use in the optimizers
is not ported yet (ROADMAP Queue 1 item 10)."""

from __future__ import annotations

import torch


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff

    def __call__(self, param_value):
        return self.coeff * torch.sign(param_value)


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff

    def __call__(self, param_value):
        return self.coeff * param_value
