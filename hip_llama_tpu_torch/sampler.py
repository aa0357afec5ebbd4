"""Samplers: greedy argmax, temperature+multinomial, top-p nucleus.

Behavioral parity with the reference (src/llama.cpp:262-422), including a
bit-exact xorshift64* RNG (llama.cpp:365-374) so deterministic test-mode runs
reproduce the same coin flips. Test mode seeds every request with 314028,
temperature 1.0, topp 0.9 (llama.cpp:897-900, sample() path at :1035).
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1
_MULT = 0x2545F4914F6CDD1D


class XorShift64Star:
    """xorshift64* — identical sequence to random_u32/random_f32 in the C code."""

    def __init__(self, seed: int):
        # xorshift64* requires a nonzero state: seed 0 would freeze the
        # stream at 0 forever (silent argmax instead of sampling); the C
        # reference is always seeded nonzero (llama.cpp:1557 time fallback)
        self.state = (seed & _MASK64) or 0x9E3779B97F4A7C15

    def next_u32(self) -> int:
        s = self.state
        s ^= s >> 12
        s = (s ^ (s << 25)) & _MASK64
        s ^= s >> 27
        self.state = s
        return ((s * _MULT) & _MASK64) >> 32

    def next_f32(self) -> float:
        # float32 in [0, 1): top 24 bits / 2^24
        return np.float32(self.next_u32() >> 8) / np.float32(16777216.0)


def softmax_f32(x: np.ndarray) -> np.ndarray:
    """Numerically-stable softmax in float32 (src/seq.cpp:18-36)."""
    x = np.asarray(x, dtype=np.float32)
    m = x.max()
    e = np.exp(x - m, dtype=np.float32)
    return e / e.sum(dtype=np.float32)


def sample_argmax(logits: np.ndarray) -> int:
    return int(np.argmax(logits))


def sample_mult(probs: np.ndarray, coin: float) -> int:
    """Inverse-CDF sampling; probs must sum to 1 (llama.cpp:288-299)."""
    cdf = np.cumsum(probs, dtype=np.float32)
    idx = int(np.searchsorted(cdf, coin, side="right"))
    return min(idx, len(probs) - 1)


def sample_topp(probs: np.ndarray, topp: float, coin: float) -> int:
    """Nucleus sampling with the reference's cutoff pre-filter
    (llama.cpp:309-350)."""
    n = len(probs)
    # float32 throughout, like the C code — a float64 cutoff/topp classifies
    # boundary probabilities differently and forks the golden token stream
    cutoff = (np.float32(1.0) - np.float32(topp)) / np.float32(n - 1)
    idx = np.nonzero(probs >= cutoff)[0]
    if len(idx) == 0:
        return sample_argmax(probs)
    order = np.argsort(-probs[idx], kind="stable")
    cand_idx = idx[order]
    cand_p = probs[cand_idx]
    cum = np.cumsum(cand_p, dtype=np.float32)
    # truncate where cumulative prob exceeds topp (include that element)
    over = np.nonzero(cum > np.float32(topp))[0]
    last = int(over[0]) if len(over) else len(cand_p) - 1
    r = np.float32(coin) * cum[last]
    pick = int(np.searchsorted(cum[: last + 1], r, side="right"))
    pick = min(pick, last)
    return int(cand_idx[pick])


class Sampler:
    """Stateful per-request sampler (llama.cpp Sampler struct + sample())."""

    def __init__(self, vocab_size: int, temperature: float = 1.0, topp: float = 0.9, seed: int = 0):
        self.vocab_size = vocab_size
        self.temperature = temperature
        self.topp = topp
        self.rng = XorShift64Star(seed)

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, dtype=np.float32)
        if self.temperature == 0.0:
            return sample_argmax(logits)
        probs = softmax_f32(logits / np.float32(self.temperature))
        coin = self.rng.next_f32()
        if self.topp <= 0 or self.topp >= 1:
            return sample_mult(probs, coin)
        return sample_topp(probs, self.topp, coin)


def request_sampler(vocab_size: int) -> Sampler:
    """The fixed-seed sampler used per request in test mode
    (llama.cpp:897-900: temp=1.0, topp=0.9, seed=314028)."""
    return Sampler(vocab_size, temperature=1.0, topp=0.9, seed=314028)
