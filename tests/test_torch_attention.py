"""The port's plain attention (hip_llama_tpu_torch/ops/attention.py) against
the JAX package: decode vs attention_decode_pallas (interpret mode) and
attention_decode_xla; prefill vs attention_prefill_pallas (interpret mode)
on its T-major and head-major branches.

Tolerances: fp32 atol = rtol = 1e-5 (the same math in another summation
order). bf16 2e-2, as tests/test_attention_pallas.py:83-85: the XLA oracle
keeps bf16 probabilities in fp32 on the CPU while the kernels round them to
bf16, and one bf16 ulp of an O(1) output is 2^-8 to 2^-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.models.llama import attention_decode_xla
from hip_llama_tpu.ops.attention import attention_decode_pallas, attention_prefill_pallas
from hip_llama_tpu_torch.ops import attention as A

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kvh,s,hs,pos",
    [
        (3, 4, 4, 32, 16, [0, 9, 32]),  # MHA: pos 0, ragged, full window
        (3, 8, 2, 64, 16, [63, 0, 17]),  # GQA 4x
        (4, 8, 4, 96, 8, [0, 95, 50, 3]),  # the golden fixture's head shape
    ],
)
def test_plain_decode_matches_jax(b, h, kvh, s, hs, pos, dtype):
    rng = np.random.default_rng(0)
    n_layers = 2
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, h, hs), (b, n_layers, kvh, s, hs), (b, n_layers, kvh, s, hs),
        (b, kvh, hs), (b, kvh, hs))]
    (qj, qt), (kj, kt), (vj, vt), (kcj, kct), (vcj, vct) = (_pair(a, dtype) for a in arrs)
    pos_j = jnp.asarray(pos, jnp.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    tol = DTYPES[dtype][2]
    for layer in range(n_layers):
        got = A.attention_decode(qt, kt, vt, layer, pos_t, kct, vct)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, hs)
        for want in (
            attention_decode_pallas(qj, kj, vj, jnp.int32(layer), pos_j, kcj, vcj, interpret=True),
            attention_decode_xla(qj, kj, vj, jnp.int32(layer), pos_j, kcj, vcj),
        ):
            assert_close(_np(got), _np(want), atol=tol, rtol=tol, msg=f"layer {layer}")


def test_plain_decode_ignores_rows_past_pos():
    rng = np.random.default_rng(1)
    b, h, kvh, s, hs = 2, 4, 2, 32, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, h, hs), (b, 1, kvh, s, hs), (b, 1, kvh, s, hs)))
    cur = torch.from_numpy(rng.standard_normal((b, kvh, hs)).astype(np.float32))
    pos = torch.tensor([5, 20], dtype=torch.int32)
    want = A.attention_decode(q, k, v, 0, pos, cur, cur)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, :, 20:] = 1e6
    v2[:, :, :, 20:] = -1e6
    assert torch.equal(A.attention_decode(q, k2, v2, 0, pos, cur, cur), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,t,h,kvh,s,hs",
    [
        (3, 16, 8, 4, 64, 128),  # T-major branch (hs % 128 == 0, 8 heads per block)
        (3, 8, 8, 4, 48, 16),  # head-major branch, GQA
        (3, 16, 4, 4, 96, 8),  # head-major, MHA, the fixture's head size
    ],
)
def test_plain_prefill_matches_jax(b, t, h, kvh, s, hs, dtype):
    rng = np.random.default_rng(2)
    n_layers = 2
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, t, h, hs), (b, n_layers, kvh, s, hs), (b, n_layers, kvh, s, hs))]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in arrs)
    # a chunk at 0, a bystander (valid 0), and a window clamped at the end
    # of the cache (start + T > S, start + valid == S)
    start = [0, 7, s - t // 2]
    valid = [t, 0, t // 2]
    start_t = torch.tensor(start, dtype=torch.int32)
    valid_t = torch.tensor(valid, dtype=torch.int32)
    tol = DTYPES[dtype][2]
    for layer in range(n_layers):
        got = A.attention_prefill(qt, kt, vt, layer, start_t, valid_t)
        want = attention_prefill_pallas(
            qj, kj, vj, jnp.int32(layer), jnp.asarray(start, jnp.int32),
            jnp.asarray(valid, jnp.int32), interpret=True)
        assert got.shape == (b, t, h, hs)
        for i in range(b):  # rows t < valid only: the rest are unspecified
            assert_close(_np(got)[i, : valid[i]], _np(want)[i, : valid[i]],
                         atol=tol, rtol=tol, msg=f"layer {layer} slot {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kvh,s,hs,pos",
    [
        (4, 4, 4, 64, 32, [0, 9, 63, 30]),  # MHA: pos 0 and ragged
        (4, 8, 2, 96, 8, [95, 0, 17, 40]),  # GQA 4x at the fixture's head size
        (2, 8, 4, 32, 16, [0, 0]),  # GQA, every slot at pos 0
    ],
)
def test_plain_decode_fused_matches_jax(b, h, kvh, s, hs, pos, dtype):
    """K5: q, k_cur and v_cur read from the head-split QKV rows, against
    attention_decode_fused in interpret mode (an even batch takes its
    batch-folded kernel)."""
    from hip_llama_tpu.ops.attention import attention_decode_fused

    rng = np.random.default_rng(3)
    n_layers = 2
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, h + 2 * kvh, hs), (b, n_layers, kvh, s, hs), (b, n_layers, kvh, s, hs))]
    (qkvj, qkvt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in arrs)
    pos_j = jnp.asarray(pos, jnp.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    tol = DTYPES[dtype][2]
    for layer in range(n_layers):
        got = A.attention_decode_fused(qkvt, kt, vt, layer, pos_t, h)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, hs)
        want = attention_decode_fused(qkvj, kj, vj, jnp.int32(layer), pos_j, n_heads=h,
                                      interpret=True)
        assert_close(_np(got), _np(want), atol=tol, rtol=tol, msg=f"layer {layer}")
        sliced = A.attention_decode(qkvt[:, :h], kt, vt, layer, pos_t, qkvt[:, h:h + kvh],
                                    qkvt[:, h + kvh:])
        assert torch.equal(got, sliced)
