"""Runnable examples of the port (counterparts of the TPU package's
``examples/``), each run as ``python -m paddle_tpu_torch.examples.<name>``."""
