"""Shared fixture of the PyTorch-port parity tests (imported by them, not
a test module itself)."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def no_jax_hybrid_topology():
    """Build the module's JAX models without a hybrid topology that
    another file's ``fleet.init`` left in the process (xdist may run such
    a file first in the same worker): the reference GPT would build
    tensor-parallel layers.  The topology is put back afterwards."""
    from paddle_tpu.distributed import topology

    saved = topology._HCG[0]
    topology._HCG[0] = None
    yield
    topology._HCG[0] = saved
