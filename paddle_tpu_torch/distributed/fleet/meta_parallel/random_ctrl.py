"""TP-aware RNG state tracker (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/random_ctrl.py``).

Named ``torch.Generator`` states, so dropout inside a tensor-parallel
region can draw from a stream of its own: ``rng_state(name)`` installs
the named state into torch's default generator of its device for the
block, then keeps the advanced state and puts the default one back.
:func:`model_parallel_random_seed` uses the reference's seed arithmetic
(the global seed ``seed``, the model-parallel stream ``seed + 1024``).
"""

from __future__ import annotations

import contextlib

import torch

from ....framework import random as _rng

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed, device="cpu"):
        """A new stream ``name`` seeded with ``seed``, for draws on
        ``device`` (the CPU by default; ``"cuda"`` for a card's dropout)."""
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        self.states_[name] = torch.Generator(device=device).manual_seed(seed)

    def get_states_tracker(self):
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states):
        for k, s in states.items():
            self.states_[k].set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        gen = self.states_[name]
        dev = gen.device
        cuda = dev.type == "cuda"
        with torch.random.fork_rng(devices=[dev] if cuda else [],
                                   device_type="cuda" if cuda else "cpu"):
            if cuda:
                torch.cuda.set_rng_state(gen.get_state(), dev)
            else:
                torch.set_rng_state(gen.get_state())
            try:
                yield
            finally:
                gen.set_state(torch.cuda.get_rng_state(dev) if cuda
                              else torch.get_rng_state())


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _TRACKER


def model_parallel_random_seed(seed=None, device="cpu"):
    import random as pyrandom

    seed = seed if seed is not None else pyrandom.randint(0, 2 ** 31 - 1)
    global_seed = seed
    local_seed = seed + 1024
    _TRACKER.reset()
    _rng.seed(global_seed)
    _TRACKER.add(MODEL_PARALLEL_RNG, local_seed, device=device)
