"""The port's Q8_0 host functions and plain matmuls
(hip_llama_tpu_torch/ops/quant.py) against the JAX package's: quantize and
dequantize bit for bit; the plain q8_matmul (K15) against q8_matmul in
interpret mode for each epilogue; the plain q8_matmul_silu (K17) and
q8_matmul_ffn (K18) against theirs at kernel-eligible widths (hidden a
multiple of 128, so the JAX kernels run), and at the golden fixture's
hidden width 192. There the JAX FFN kernels decline by default (a TPU tile
rule, quant.py:639-643) and their fallback rounds h1 and h3 to bf16 before
the gate, a cast point the port's kernels do not have; the JAX package's
block knob (block_n 64) makes its q8_matmul_silu kernel run there in
interpret mode. Both routes hold at the same bf16 tolerance.

Tolerance: bf16 outputs at atol = rtol = 2e-2 (tests/test_attention_pallas.py:
83-85): both sides have the same cast points and differ in the fp32
summation order, which can move an output by one bf16 ulp (2^-8 to 2^-7 of
an O(1) value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.ops import quant as jq
from hip_llama_tpu_torch.ops import quant as Q

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)
K, N = 256, 384


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _weights(rng, k, n, gs):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return jq.q8_quantize_weights(jnp.asarray(w), gs), Q.q8_quantize_weights(torch.from_numpy(w), gs)


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("gs", [32, 64])
@pytest.mark.parametrize("shape", [(128, 96), (3, 192, 40)])
def test_quantize_and_dequantize_bit_exact(gs, shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., :gs, 0] = 0.0  # an all-zero group takes scale 1
    jt, pt = jq.q8_quantize_weights(jnp.asarray(w), gs), Q.q8_quantize_weights(torch.from_numpy(w), gs)
    assert pt.q.dtype == torch.int8 and pt.s.dtype == torch.float32 and pt.group_size == gs
    np.testing.assert_array_equal(pt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(pt.s.numpy(), np.asarray(jt.s))
    np.testing.assert_array_equal(Q.q8_dequantize(pt).numpy(), np.asarray(jq.q8_dequantize(jt)))


# (M, gs, epilogue): every epilogue, every row count of the decode and
# prefill shapes, both group sizes
CASES = [
    (1, 32, "none"), (8, 64, "none"), (40, 32, "none"),
    (1, 64, "norm"), (8, 32, "norm"), (40, 64, "norm"),
    (1, 32, "residual"), (8, 64, "residual"), (40, 32, "residual"),
    (8, 32, "norm_rope_hs32"), (40, 64, "norm_rope_hs32"),
    (1, 64, "norm_rope_hs128"), (40, 32, "norm_rope_hs128"),
    (8, 64, "heads_hs32"), (40, 32, "heads_hs128"),
]


@pytest.mark.parametrize("m,gs,epi", CASES)
def test_plain_q8_matmul_matches_jax(m, gs, epi):
    rng = np.random.default_rng(m * 100 + gs)
    jt, pt = _weights(rng, K, N, gs)
    xj, xp = _bf16(rng.standard_normal((m, K)))
    jkw, pkw = {}, {}
    if epi != "none" and epi != "residual":
        g = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        jkw["norm_weight"], pkw["norm_weight"] = jnp.asarray(g), torch.from_numpy(g)
    if epi == "residual":
        rj, rp = _bf16(rng.standard_normal((m, N)))
        jkw["residual"], pkw["residual"] = rj, rp
    hs = int(epi[-3:].lstrip("s")) if "hs" in epi else 0
    if "rope" in epi or "heads" in epi:
        pos = rng.integers(0, 2048, m).astype(np.int32)
        pos[0] = 0
        # q|k rotate, v (the last third) passes through
        jkw.update(rope_pos=jnp.asarray(pos), rope_limit=256, rope_head=hs, rope_theta=10000.0)
        pkw.update(rope_pos=torch.from_numpy(pos), rope_limit=256, rope_head=hs,
                   rope_theta=10000.0)
    if "heads" in epi:
        jkw["out_heads"] = hs
    want = jq.q8_matmul(xj, jt, interpret=True, **jkw)
    got = Q.q8_matmul(xp, pt, **pkw)
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    if "heads" in epi:
        got = got.view(m, N // hs, hs)  # the head-split layout is a view
        assert want.shape == got.shape
    assert_close(_np(got), _np(want), **TOL, msg=f"{epi} M {m} gs {gs}")


@pytest.mark.parametrize("m", [8, 40])
def test_plain_q8_matmul_silu_matches_jax(m):
    k, h, gs = 128, 256, 32
    rng = np.random.default_rng(m)
    jt, pt = _weights(rng, k, 2 * h, gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    want = jq.q8_matmul_silu(xj, jt, interpret=True, norm_weight=jnp.asarray(g))
    got = Q.q8_matmul_silu(xp, pt, norm_weight=torch.from_numpy(g))
    assert got.shape == (m, h)
    assert_close(_np(got), _np(want), **TOL)


def test_plain_q8_matmul_ffn_matches_jax():
    k, h, gs, m = 128, 256, 32, 8
    rng = np.random.default_rng(3)
    j13, p13 = _weights(rng, k, 2 * h, gs)
    j2, p2 = _weights(rng, h, k, gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    want = jq.q8_matmul_ffn(xj, j13, j2, xj, jnp.asarray(g), interpret=True)
    got = Q.q8_matmul_ffn(xp, p13, p2, xp, torch.from_numpy(g))
    assert got.shape == (m, k)
    assert_close(_np(got), _np(want), **TOL)
    # and it is the gate followed by W2 with the residual
    two = Q.q8_matmul(Q.q8_matmul_silu(xp, p13, norm_weight=torch.from_numpy(g)), p2, residual=xp)
    assert_close(_np(got), _np(two), **TOL)


@pytest.mark.parametrize("route", ["kernel", "fallback"])
def test_plain_ffn_at_fixture_width_matches_jax(route):
    """Hidden 192, the golden fixture's: K17 and K18 against the JAX
    package's kernel route (block_n 64) and its default fallback."""
    k, h, gs, m = 64, 192, 64, 8
    rng = np.random.default_rng(11)
    j13, p13 = _weights(rng, k, 2 * h, gs)
    j2, p2 = _weights(rng, h, k, gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    kw = {"block_n": 64} if route == "kernel" else {}
    want = jq.q8_matmul_silu(xj, j13, interpret=True, norm_weight=jnp.asarray(g), **kw)
    got = Q.q8_matmul_silu(xp, p13, norm_weight=torch.from_numpy(g))
    assert_close(_np(got), _np(want), **TOL, msg=f"K17 {route}")
    want = jq.q8_matmul(jq.q8_matmul_silu(xj, j13, interpret=True, norm_weight=jnp.asarray(g),
                                          **kw), j2, interpret=True, residual=xj)
    got = Q.q8_matmul_ffn(xp, p13, p2, xp, torch.from_numpy(g))
    assert_close(_np(got), _np(want), **TOL, msg=f"K18 {route}")


def test_ffn_row_rule_matches_jax():
    """K18 serves up to 256 rows whose x fits 2 MiB in fp32 (quant.py:934):
    at Llama-2-7B width that is M <= 128."""
    assert Q.ffn_takes_kernel(128, 4096) and not Q.ffn_takes_kernel(129, 4096)
    assert Q.ffn_takes_kernel(256, 128) and not Q.ffn_takes_kernel(257, 128)


def test_gemv_plan_covers_k():
    for k, n in [(64, 128), (4096, 12288), (4096, 4096), (4096, 32000), (11008, 4096),
                 (4096, 22016), (192, 512)]:
        split, kslice = Q.gemv_plan(k, n)
        assert kslice % 64 == 0 and kslice <= 1024
        assert (split - 1) * kslice < k <= split * kslice, (k, n, split, kslice)
