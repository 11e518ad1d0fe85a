"""paddle_tpu_torch.utils (counterpart of ``paddle_tpu/utils``): the
custom-op plugin surface, re-exported as the TPU package does."""

from ..framework.custom_op import load_op_library, register_op  # noqa: F401
