"""PyTorch port, the serving sampler: ``make_batched_sampler`` against the
JAX package's on the same numpy logits.  Greedy rows and rows holding NaN
or inf give JAX's token exactly (Gumbel-max has JAX's argmax on every
non-finite row); sampled rows are reproducible from one
``torch.Generator`` seed and follow ``softmax(filter(l / T))`` in
frequency; a batch with a NaN row raises nothing, in the sampler or in the
CPU ``ServingEngine``, where it used to fail every in-flight request."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from paddle_tpu.text.models._decode import apply_top_k_top_p as j_filter
from paddle_tpu.text.models._decode import make_batched_sampler as j_sampler
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.models import GPTForCausalLM
from paddle_tpu_torch.text.models._decode import make_batched_sampler
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

# (top_k, top_p): no filter, top-k, nucleus, both
FILTERS = [(0, 1.0), (3, 1.0), (0, 0.9), (3, 0.9)]
V = 16


def _mixed_batch():
    """Logits [10, V] and temperatures: finite rows greedy and sampled,
    then a NaN row, a row with two +inf and an all -inf row, each once
    greedy and once at temperature 0.8."""
    rs = np.random.RandomState(0)
    finite = rs.randn(4, V).astype(np.float32) * 2
    nan_row = rs.randn(V).astype(np.float32)
    nan_row[[3, 9]] = np.nan
    inf_row = rs.randn(V).astype(np.float32)
    inf_row[[5, 11]] = np.inf
    ninf_row = np.full(V, -np.inf, np.float32)
    logits = np.stack([*finite, nan_row, nan_row, inf_row, inf_row,
                       ninf_row, ninf_row])
    temps = np.array([0, 0, 0.8, 0.8] + [0, 0.8] * 3, np.float32)
    return logits, temps


@pytest.mark.parametrize("top_k,top_p", FILTERS)
def test_mixed_batch_matches_jax(top_k, top_p):
    """Every row gets a token and nothing raises; greedy rows and every
    non-finite row (greedy or sampled) equal JAX's tokens exactly."""
    logits, temps = _mixed_batch()
    gen = torch.Generator().manual_seed(0)
    got = make_batched_sampler(top_k, top_p)(
        torch.from_numpy(logits), torch.from_numpy(temps), gen).numpy()
    want = np.asarray(j_sampler(top_k, top_p)(
        jnp.asarray(logits), jnp.asarray(temps), jax.random.PRNGKey(0)))
    assert got.shape == (len(logits),)
    assert ((got >= 0) & (got < V)).all()
    exact = (temps <= 0) | ~np.isfinite(logits).all(-1)
    np.testing.assert_array_equal(got[exact], want[exact])
    assert list(got[4:]) == [3, 3, 5, 5, 0, 0]


@pytest.mark.parametrize("top_k,top_p", FILTERS)
def test_sampled_rows_reproducible_from_seed(top_k, top_p):
    logits, temps = _mixed_batch()
    lt, tt = torch.from_numpy(np.tile(logits, (50, 1))), \
        torch.from_numpy(np.tile(temps, 50))
    sample = make_batched_sampler(top_k, top_p)

    def draw(seed):
        return sample(lt, tt, torch.Generator().manual_seed(seed))

    assert torch.equal(draw(7), draw(7))
    assert not torch.equal(draw(7), draw(8))


@pytest.mark.parametrize("top_k,top_p", FILTERS)
def test_sampled_frequencies_follow_softmax(top_k, top_p):
    """20,000 draws of one row at temperature 0.8: the token frequencies
    against softmax of the JAX package's filtered ``l / T`` (chi-square,
    p > 1e-6), and no token outside the filter's kept set."""
    n, temp = 20000, 0.8
    row = np.random.RandomState(1).randn(6).astype(np.float32)
    kept = np.asarray(j_filter(jnp.asarray(row[None] / temp), top_k, top_p))[0]
    p = np.exp(kept - kept.max())
    p /= p.sum()
    tok = make_batched_sampler(top_k, top_p)(
        torch.from_numpy(np.tile(row, (n, 1))),
        torch.full((n,), temp), torch.Generator().manual_seed(3)).numpy()
    counts = np.bincount(tok, minlength=6)
    live = p > 0
    assert counts[~live].sum() == 0
    expect = n * p[live]
    chi2 = ((counts[live] - expect) ** 2 / expect).sum()
    assert chi2 < scipy.stats.chi2.ppf(1 - 1e-6, live.sum() - 1), (counts, p)


@pytest.mark.parametrize("poisoned", ["greedy", "sampled"])
def test_engine_nan_row_aborts_no_request(poisoned):
    """A greedy request (slot 0) and a sampled one (slot 1) share a decode
    step whose logits hold a NaN row (patched in the adapter here).  Both
    complete with all their tokens; none is aborted."""
    torch.manual_seed(0)
    model = GPTForCausalLM(device="cpu", vocab_size=96, hidden_size=32,
                           num_hidden_layers=2, num_attention_heads=2,
                           max_position_embeddings=64).eval()
    eng = ServingEngine(model, device="cpu", num_slots=2, page_size=8,
                        max_model_len=64, top_k=5, top_p=0.9)
    step = eng._adapter.step
    poisoned_steps = []

    def nan_step(*args):
        logits, *pools = step(*args)
        if not poisoned_steps and all(s is not None for s in eng._slots):
            poisoned_steps.append(1)
            logits = logits.clone()
            logits[0 if poisoned == "greedy" else 1] = float("nan")
        return (logits, *pools)

    eng._adapter.step = nan_step
    with eng:
        greedy = eng.submit([5, 6, 7], max_new_tokens=6)
        sampled = eng.submit([9, 10, 11, 12], max_new_tokens=6,
                             temperature=0.8)
        outs = [h.result(timeout=120) for h in (greedy, sampled)]
    assert poisoned_steps
    assert [len(o) for o in outs] == [6, 6]
    assert greedy.status == sampled.status == "completed"
    assert eng.stats()["error"] is None
