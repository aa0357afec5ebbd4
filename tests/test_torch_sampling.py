"""The port's sampling on the device (hip_llama_tpu_torch/models/llama.py::
make_logit_sampler) and the speculative verifier's host functions
(hip_llama_tpu_torch/engine/speculative.py) against the JAX package's.

- Greedy is np.argmax: the first index among equal maxima.
- The stochastic branch keeps exactly the support of the JAX `_warp`
  (temperature, softmax, the top-p nucleus) and draws from its distribution:
  over 40000 seeded draws a row's empirical distribution is within a total
  variation of 0.02 of `_warp`'s (the sampling noise of 40000 draws over a
  few dozen tokens is about 0.01). JAX's PRNG stream is not reproduced, so
  the draws are held to the distribution and to their seed, not to the JAX
  sampler's tokens.
- `_warp`, `_verify_round` and `_lookup_propose` are numpy: the port's
  equal the JAX ones exactly on the same inputs and xorshift64* seeds.
"""

import numpy as np
import pytest
import torch

from hip_llama_tpu.engine.speculative import _lookup_propose as jax_lookup_propose
from hip_llama_tpu.engine.speculative import _verify_round as jax_verify_round
from hip_llama_tpu.engine.speculative import _warp as jax_warp
from hip_llama_tpu.sampler import XorShift64Star as JaxXorShift
from hip_llama_tpu_torch.engine.speculative import _lookup_propose, _verify_round, _warp
from hip_llama_tpu_torch.models.llama import make_logit_sampler, warp_logits
from hip_llama_tpu_torch.sampler import XorShift64Star, sample_mult

torch.set_num_threads(1)

N_DRAWS = 40_000
TV_BAR = 0.02


def _rows() -> np.ndarray:
    """Logit rows of 24 tokens: peaked, flat, two-way tie at the top, and
    a long tail."""
    rng = np.random.default_rng(11)
    rows = [rng.standard_normal(24) * 3.0, rng.standard_normal(24) * 0.3,
            np.concatenate([[4.0, 4.0], rng.standard_normal(22)]),
            np.linspace(3.0, -6.0, 24)]
    return np.asarray(rows, np.float32)


def test_greedy_takes_the_first_of_equal_maxima():
    logits = np.array([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0], [-1.0, -2.0, -1.0, -3.0],
                       [0.0, 0.0, 7.0, 7.0]], np.float32)
    got = make_logit_sampler(0.0)(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    assert got.tolist() == np.argmax(logits, axis=-1).tolist()


@pytest.mark.parametrize("topp", [0.5, 0.9, 1.0])
@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_stochastic_keeps_the_jax_support_and_distribution(temperature, topp):
    rows = _rows()
    sample = make_logit_sampler(temperature, topp)
    gen = torch.Generator().manual_seed(1234)
    for r, row in enumerate(rows):
        want = jax_warp(row, temperature, topp)
        kept = torch.isfinite(warp_logits(torch.from_numpy(row), temperature, topp)).numpy()
        assert set(np.nonzero(kept)[0]) == set(np.nonzero(want)[0]), f"row {r}"
        draws = sample(torch.from_numpy(np.tile(row, (N_DRAWS, 1))), gen)
        emp = np.bincount(draws.numpy(), minlength=len(row)) / N_DRAWS
        tv = 0.5 * float(np.abs(emp - want).sum())
        assert tv <= TV_BAR, f"row {r}: total variation {tv}"
        assert set(np.nonzero(emp)[0]) <= set(np.nonzero(want)[0])


def test_same_seed_same_draws_other_seed_other_draws():
    logits = torch.from_numpy(np.tile(_rows()[1], (64, 1)))
    sample = make_logit_sampler(1.0, 0.9)

    def draws(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.stack([sample(logits, gen) for _ in range(4)])

    assert torch.equal(draws(7), draws(7))
    assert not torch.equal(draws(7), draws(8))


@pytest.mark.parametrize("topp", [0.5, 0.9, 1.0])
@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.0])
def test_warp_equals_the_jax_warp(temperature, topp):
    for row in _rows():
        np.testing.assert_array_equal(_warp(row, temperature, topp),
                                      jax_warp(row, temperature, topp))


@pytest.mark.parametrize("seed", [1, 99, 12345])
@pytest.mark.parametrize("point_mass", [False, True])
def test_verify_round_equals_the_jax_verify_round(seed, point_mass):
    rows = _rows()
    rng_np = np.random.default_rng(seed)
    for k in (1, 3):
        for trial in range(30):
            ps = [_warp(rows[(trial + i) % 4] + rng_np.standard_normal(24).astype(np.float32),
                        1.0, 0.9) for i in range(k + 1)]
            qs = None if point_mass else [_warp(rows[(trial + i + 1) % 4], 0.8, 0.9)
                                          for i in range(k)]
            d_toks = [int(rng_np.integers(24)) for _ in range(k)]
            ours, theirs = XorShift64Star(seed + trial), JaxXorShift(seed + trial)
            assert _verify_round(ps, qs, d_toks, ours) == jax_verify_round(ps, qs, d_toks, theirs)
            assert ours.state == theirs.state


def test_verify_round_marginal_is_the_target():
    """The committed first token of a round is distributed as the target p,
    whatever q proposes (tests/test_speculative.py's check, on the port)."""
    rng = XorShift64Star(12345)
    p = np.array([0.40, 0.30, 0.20, 0.05, 0.05, 0.00], np.float32)
    q = np.array([0.10, 0.50, 0.20, 0.10, 0.05, 0.05], np.float32)
    bonus = np.full(6, 1 / 6, np.float32)
    counts = np.zeros(6)
    for _ in range(N_DRAWS):
        x = sample_mult(q, rng.next_f32())
        commits, _ = _verify_round([p, bonus], [q], [x], rng)
        counts[commits[0]] += 1
    np.testing.assert_allclose(counts / N_DRAWS, p, atol=0.02)


@pytest.mark.parametrize("history,k", [
    ([1, 5, 9, 5, 9], 4), ([1, 2, 3, 4], 3), ([7, 7, 7, 7], 2), ([1], 4),
    ([3, 1, 4, 1, 5, 9, 2, 6, 1, 4, 1], 5), ([2, 8, 2, 8, 2], 1),
])
def test_lookup_propose_equals_the_jax_lookup(history, k):
    assert _lookup_propose(history, k) == jax_lookup_propose(history, k)
