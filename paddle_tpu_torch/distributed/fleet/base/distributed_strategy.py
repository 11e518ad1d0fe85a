"""DistributedStrategy — the distributed config surface (a copy of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``).

A plain typed object with the reference's knob names; ``fleet.init``
reads ``hybrid_configs``.  The knobs that configured graph-rewrite meta
optimizers (``fuse_all_reduce_ops``, ``localsgd``, ...) are accepted and
recorded, and have no effect, as in the reference.
"""

from __future__ import annotations


_HYBRID_DEFAULTS = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "micro_batch_size": 1,
    "accumulate_steps": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
}


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = dict(_HYBRID_DEFAULTS)
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0, "use_pure_fp16": False,
                            "use_pure_bf16": False, "custom_white_list": [],
                            "custom_black_list": []}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "sharding_degree": 1, "offload": False}
        self.pipeline = False
        self.pipeline_configs = dict(self._PIPELINE_DEFAULTS)
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.fuse_all_reduce_ops = True   # recorded, not read
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.without_graph_optimization = False
        self.asp = False
        self.a_sync = False
        self.a_sync_configs = {}

    _PIPELINE_DEFAULTS = {"micro_batch_size": 1, "accumulate_steps": 1,
                          "schedule_mode": "1F1B"}

    def __setattr__(self, k, v):
        if k == "hybrid_configs" and hasattr(self, "hybrid_configs"):
            merged = dict(_HYBRID_DEFAULTS)
            merged.update(v or {})
            object.__setattr__(self, k, merged)
        elif k == "pipeline_configs" and hasattr(self, "pipeline_configs"):
            # partial dicts merge onto the CURRENT config (reference
            # protobuf assign semantics): earlier settings survive and
            # schedule_mode never vanishes
            merged = dict(self.pipeline_configs)
            merged.update(v or {})
            object.__setattr__(self, k, merged)
        else:
            object.__setattr__(self, k, v)

    def __repr__(self):
        hc = self.hybrid_configs
        return (f"DistributedStrategy(dp={hc['dp_degree']}, mp={hc['mp_degree']}, "
                f"pp={hc['pp_degree']}, sharding={hc['sharding_degree']}, "
                f"sep={hc['sep_degree']})")
