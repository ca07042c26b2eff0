"""The port's sampler against the JAX package's ``repro.serve.sampler``.

``sample`` takes a ``torch.Generator`` where JAX takes a key, so its draws
are held to the distribution; its filters (temperature, top-k, top-p) must
mask exactly the positions JAX's mask, read from the logits JAX hands to
``jax.random.categorical``.  ``greedy_verify`` and ``rejection_verify`` are
host numpy on both sides: the same inputs and the same numpy generator give
the same outputs.  The cases mirror ``tests/test_sampler.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.serve import sampler as jsampler  # noqa: E402
from repro_torch.serve.sampler import (  # noqa: E402
    filter_logits,
    greedy_verify,
    rejection_verify,
    sample,
)


def _logits(probs):
    return torch.log(torch.tensor(probs, dtype=torch.float32))[None, :]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------- sample ---


def test_greedy_is_argmax_and_needs_no_generator():
    logits = _logits([0.1, 0.2, 0.6, 0.1])
    assert int(sample(logits)[0]) == 2
    assert int(sample(logits, temperature=0.0)[0]) == 2
    # a generator without temperature still decodes greedily, and a
    # temperature without a generator too (JAX: no key means argmax)
    assert int(sample(logits, _gen(0))[0]) == 2
    assert int(sample(logits, temperature=1.5, top_k=3)[0]) == 2
    assert int(jsampler.sample(jnp.asarray(logits.numpy()), temperature=1.5)[0]) == 2


def test_seeded_determinism():
    logits = torch.tensor(np.random.default_rng(0).standard_normal((4, 64)),
                          dtype=torch.float32)
    a = sample(logits, _gen(7), temperature=1.0)
    b = sample(logits, _gen(7), temperature=1.0)
    c = sample(logits, _gen(8), temperature=1.0)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_low_temperature_approaches_greedy():
    logits = _logits([0.05, 0.9, 0.05])
    toks = {int(sample(logits, _gen(i), temperature=0.01)[0]) for i in range(16)}
    assert toks == {1}


def test_top_k_restricts_support():
    logits = _logits([0.4, 0.3, 0.2, 0.1])
    seen = {int(sample(logits, _gen(i), temperature=2.0, top_k=2)[0])
            for i in range(64)}
    assert seen <= {0, 1} and len(seen) == 2


def test_top_p_restricts_support_to_minimal_nucleus():
    # cumulative mass before each sorted token: 0, .5, .8, .95 -> top_p=0.6
    # keeps exactly {0, 1}
    logits = _logits([0.5, 0.3, 0.15, 0.05])
    seen = {int(sample(logits, _gen(i), temperature=1.0, top_p=0.6)[0])
            for i in range(128)}
    assert seen == {0, 1}
    seen = {int(sample(logits, _gen(i), temperature=1.0, top_p=1e-6)[0])
            for i in range(16)}
    assert seen == {0}


def test_temperature_sampling_matches_softmax_distribution():
    probs = np.asarray([0.45, 0.35, 0.15, 0.05])
    n = 4000
    logits = torch.log(torch.tensor(probs, dtype=torch.float32)).repeat(n, 1)
    toks = sample(logits, _gen(0), temperature=1.0)
    freq = np.bincount(toks.numpy(), minlength=4) / n
    np.testing.assert_allclose(freq, probs, atol=0.03)
    assert toks.shape == (n,)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 0.0), (0.7, 5, 0.0), (1.3, 0, 0.9), (0.8, 8, 0.5), (2.0, 1, 0.3),
])
def test_filters_mask_the_positions_jax_masks(monkeypatch, temperature, top_k, top_p):
    """The logits the JAX sampler draws from (captured at its categorical
    draw) against ``filter_logits``: the same ``-inf`` positions, the same
    finite values."""
    logits = np.random.default_rng(5).standard_normal((6, 96)).astype(np.float32)
    seen = {}

    def categorical(key, lg):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, -1)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jsampler.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                    temperature=temperature, top_k=top_k, top_p=top_p)
    want = seen["logits"]
    got = filter_logits(torch.from_numpy(logits), temperature=temperature,
                        top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6)
    # and draws land only where JAX's filters leave mass
    draws = torch.stack([sample(torch.from_numpy(logits), _gen(i),
                                temperature=temperature, top_k=top_k,
                                top_p=top_p) for i in range(32)])
    assert finite[np.arange(6)[None, :].repeat(32, 0), draws.numpy()].all()


# --------------------------------------------------------- greedy_verify ---


def _same_as_jax(fn, *args):
    out = getattr(jsampler, fn.__name__)(*args)
    assert fn(*args) == out
    return out


def test_greedy_verify_full_acceptance_emits_bonus():
    n, emitted = _same_as_jax(greedy_verify, np.asarray([5, 6, 7, 9]), [5, 6, 7])
    assert n == 3 and emitted == [5, 6, 7, 9]


def test_greedy_verify_first_mismatch_corrects():
    n, emitted = _same_as_jax(greedy_verify, np.asarray([5, 8, 7, 9]), [5, 6, 7])
    assert n == 1 and emitted == [5, 8]
    n, emitted = _same_as_jax(greedy_verify, np.asarray([4, 8, 7, 9]), [5, 6, 7])
    assert n == 0 and emitted == [4]


def test_greedy_verify_empty_draft_is_plain_decode():
    n, emitted = _same_as_jax(greedy_verify, np.asarray([3, 0, 0]), [])
    assert n == 0 and emitted == [3]


# ------------------------------------------------------ rejection_verify ---


def test_rejection_verify_deterministic_extremes():
    V = 4
    p = np.zeros((3, V))
    p[0, 1] = p[1, 2] = 1.0
    p[2, 3] = 1.0
    n, emitted = rejection_verify(p, [1, 2], np.random.default_rng(0))
    assert n == 2 and emitted == [1, 2, 3]
    p = np.zeros((2, V))
    p[0, 2] = 1.0
    for seed in range(8):
        n, emitted = rejection_verify(p, [1], np.random.default_rng(seed))
        assert n == 0 and emitted == [2]


def test_rejection_verify_preserves_target_marginal():
    """The emitted first token is distributed like the target, whatever the
    deterministic draft, and each trial equals JAX's on the same numpy
    stream."""
    V = 4
    target = np.asarray([0.5, 0.25, 0.15, 0.1])
    p = np.zeros((2, V))
    p[0] = target
    p[1] = 1.0 / V
    rng, jrng = np.random.default_rng(42), np.random.default_rng(42)
    n_trials = 6000
    for draft_tok in (0, 2):
        counts = np.zeros(V)
        for _ in range(n_trials):
            _, emitted = rejection_verify(p, [draft_tok], rng)
            assert (_, emitted) == jsampler.rejection_verify(p, [draft_tok], jrng)
            counts[emitted[0]] += 1
        np.testing.assert_allclose(counts / n_trials, target, atol=0.03)


def test_rejection_verify_emits_between_1_and_k_plus_1():
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    p = np.random.default_rng(4).dirichlet(np.ones(8), size=4)
    for _ in range(32):
        n, emitted = rejection_verify(p, [1, 2, 3], rng)
        assert (n, emitted) == jsampler.rejection_verify(p, [1, 2, 3], jrng)
        assert 0 <= n <= 3 and len(emitted) == n + 1
