"""paddle_tpu_torch.distributed.fleet.base: ``DistributedStrategy``."""
