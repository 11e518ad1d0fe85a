"""paddle_tpu_torch.jit (counterpart of ``paddle_tpu/jit``): the training
step.  ``to_static`` and the rest of the TPU package's ``jit`` are not
ported."""

from .train_step import TrainStep, train_step  # noqa: F401
