"""The int8 decode attention (K1, K5, K6 on an int8 KV cache) at the edges
of the JAX kernels' KV blocks, on the CPU: the port's plain versions
(hip_llama_tpu_torch/ops/attention.py), which the CUDA task
(csrc/decode_attention.cuh::decode_attention_task_int8) is held to on the
card, against the JAX kernels in interpret mode (attention_decode_pallas,
attention_decode_fused, attention_decode_paged; their i8mxu branch,
_decode_kernel_bfold), from numpy seeds.

The block decides which probabilities share an int8 scale, so the slots sit
at positions 0 (the current row only), bk - 1, bk, bk + 1 (a block of one
row after a whole one) and S - 1; the blocks are 128 and 1024 rows (dense
caches of 512 and 2048 rows, `decode_block`) and 128 and 512 (pages, the
JAX paged kernels' block); 1, 4, 8 and 12 query heads per KV head (12: a
task of 8 and one of 4 on the card); head sizes 48, 128 and 256.

Tolerances: as tests/test_torch_kv_int8.py, fp32 q at atol = rtol = 1e-5
(the int8 dots are exact on both sides; the softmax sums in another order),
bf16 q at 2e-2 (one bf16 ulp of an O(1) output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.ops.attention import attention_decode_fused as jax_decode_fused
from hip_llama_tpu.ops.attention import attention_decode_paged as jax_decode_paged
from hip_llama_tpu.ops.attention import attention_decode_pallas
from hip_llama_tpu_torch.ops import attention as A
from hip_llama_tpu_torch.ops import cache as C

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

ACT = {"float32": (jnp.float32, torch.float32, 1e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _t(x, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))).to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _planes(rng, shape):
    """Int8 K and V planes with their row scales, quantized from normal
    draws, as numpy (k, v, ks, vs)."""
    out = []
    for _ in range(2):
        q, sc = C.quantize_kv_rows(_t(rng.standard_normal(shape)))
        out.append((q.numpy(), sc.numpy()))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _edges(bk: int, s: int) -> list[int]:
    return [0, bk - 1, bk, bk + 1, s - 1]


def _acts(rng, jd, b, h, kvh, hs):
    """q, k_cur, v_cur as numpy values of the activation dtype."""
    return [np.asarray(jnp.asarray(rng.standard_normal(sh), jd).astype(jnp.float32))
            for sh in ((b, h, hs), (b, kvh, hs), (b, kvh, hs))]


# (S, query heads per KV head, KV heads, head size, activation dtype): the
# dense cache's block is decode_block(S) — 128 at S 512, 1024 at S 2048
DENSE_CASES = [
    (512, 1, 2, 128, "float32"),
    (512, 12, 1, 48, "bfloat16"),
    (2048, 4, 1, 256, "float32"),
    (2048, 8, 1, 48, "float32"),
    (2048, 1, 2, 128, "bfloat16"),
]


@pytest.mark.parametrize("s,m,kvh,hs,act", DENSE_CASES)
def test_plain_int8_decode_matches_jax_at_the_block_edges(s, m, kvh, hs, act):
    jd, td, tol = ACT[act]
    bk = A.decode_block(s, True)
    assert bk == {512: 128, 2048: 1024}[s]
    pos = _edges(bk, s)
    b, h = len(pos), m * kvh
    rng = np.random.default_rng(s + m + hs)
    k, v, ks, vs = _planes(rng, (b, 1, kvh, s, hs))
    q, kc, vc = _acts(rng, jd, b, h, kvh, hs)
    pc = [_t(k, torch.int8), _t(v, torch.int8), _t(ks), _t(vs)]
    jc = [jnp.asarray(x) for x in (k, v, ks, vs)]
    pos_t, pos_j = torch.tensor(pos, dtype=torch.int32), jnp.asarray(pos, jnp.int32)
    got = A.attention_decode(_t(q, td), pc[0], pc[1], 0, pos_t, _t(kc, td), _t(vc, td),
                             pc[2], pc[3])
    want = attention_decode_pallas(jnp.asarray(q, jd), jc[0], jc[1], jnp.int32(0), pos_j,
                                   jnp.asarray(kc, jd), jnp.asarray(vc, jd), jc[2], jc[3],
                                   interpret=True)
    assert_close(_np(got), _np(want), atol=tol, rtol=tol, msg="K1")
    qkv = np.concatenate([q, kc, vc], axis=1)
    fused = A.attention_decode_fused(_t(qkv, td), pc[0], pc[1], 0, pos_t, h, pc[2], pc[3])
    want = jax_decode_fused(jnp.asarray(qkv, jd), jc[0], jc[1], jnp.int32(0), pos_j, jc[2],
                            jc[3], n_heads=h, interpret=True)
    assert_close(_np(fused), _np(want), atol=tol, rtol=tol, msg="K5")
    assert torch.equal(fused, got)


# (page size = the block, pages a slot, query heads per KV head, KV heads,
# head size, activation dtype)
PAGED_CASES = [
    (128, 4, 8, 1, 256, "float32"),
    (512, 2, 4, 1, 128, "bfloat16"),
    (128, 3, 12, 1, 48, "float32"),
    (512, 2, 1, 2, 48, "float32"),
    (128, 4, 1, 4, 128, "bfloat16"),
]


@pytest.mark.parametrize("ps,max_pages,m,kvh,hs,act", PAGED_CASES)
def test_plain_int8_paged_decode_matches_jax_at_the_page_edges(ps, max_pages, m, kvh, hs, act):
    jd, td, tol = ACT[act]
    s = ps * max_pages
    pos = _edges(ps, s)
    b, h = len(pos), m * kvh
    n_pages = b * max_pages + 1
    rng = np.random.default_rng(ps + m + hs)
    k, v, ks, vs = _planes(rng, (1, kvh, n_pages, ps, hs))
    table = rng.permutation(np.arange(1, n_pages))[: b * max_pages].reshape(b, max_pages)
    table = table.astype(np.int32)
    q, kc, vc = _acts(rng, jd, b, h, kvh, hs)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    got = A.attention_decode_paged(_t(q, td), _t(k, torch.int8), _t(v, torch.int8),
                                   torch.from_numpy(table), 0, pos_t, _t(kc, td), _t(vc, td),
                                   _t(ks), _t(vs))
    want = jax_decode_paged(jnp.asarray(q, jd), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(table), jnp.int32(0), jnp.asarray(pos, jnp.int32),
                            jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(ks),
                            jnp.asarray(vs), interpret=True)
    assert_close(_np(got), _np(want), atol=tol, rtol=tol, msg="K6")
