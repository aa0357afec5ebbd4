"""The fp32/bf16 decode attention (K1, K5, K6 on fp32 and bf16 KV caches) at
the edges of the JAX kernels' KV blocks, on the CPU: the port's plain
versions (hip_llama_tpu_torch/ops/attention.py), which the CUDA task
(csrc/decode_attention.cuh::decode_attention_task) is held to on the card,
against the JAX kernels in interpret mode (attention_decode_pallas,
attention_decode_fused, attention_decode_paged), from numpy seeds. The
bf16/fp32 twin of tests/test_torch_decode_int8.py.

On a bf16 cache the block decides the running max at which the
probabilities round to bf16, so the slots sit at positions 0 (the current
row only), bk - 1, bk, bk + 1 (a block of one row after a whole one) and
S - 1; the blocks are 128 and 1024 rows (dense caches of 512 and 2048 rows,
`decode_block`) and 128 and 512 (pages, the JAX paged kernels' block); 1,
4, 8 and 12 query heads per KV head (12: a task of 8 and one of 4 on the
card); head sizes 48, 128 and 256.

Tolerances: fp32 atol = rtol = 1e-5 (the same math in another summation
order); bf16 one bf16 ulp of the output's magnitude and at least 2^-8
absolute, chip_smoke's ATTN_ATOL (both sides round p to bf16 at the same
block max; an fp32 sum in another order can move an output across one bf16
rounding boundary), and at most 2% of the bf16 outputs moved at all: 0.94%
at most on these seeds, where the plain version at blocks of 64 rows moves
14-32% of them (which the ulp bound alone does not see).
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

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

CACHE = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_ATOL = 2.0 ** -8


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check(got, want, dtype: str, msg: str) -> None:
    g, w = _np(got), _np(want)
    if dtype == "float32":
        assert_close(g, w, atol=1e-5, rtol=1e-5, msg=msg)
        return
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    bound = np.maximum(ulp, ATTN_ATOL)
    err = np.abs(g - w)
    assert (err <= bound).all(), (msg, float(err.max()), float((err - bound).max()))
    assert (err > 0).mean() <= 0.02, (msg, float((err > 0).mean()))


def _draw(rng, dtype: str, *shapes):
    """Normal draws of each shape as values of the cache dtype, numpy fp32."""
    jd = CACHE[dtype][0]
    return [np.asarray(jnp.asarray(rng.standard_normal(sh), jd).astype(jnp.float32))
            for sh in shapes]


def _t(x, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(CACHE[dtype][1])


def _j(x, dtype: str):
    return jnp.asarray(x, CACHE[dtype][0])


def _edges(bk: int, s: int) -> list[int]:
    return [0, bk - 1, bk, bk + 1, s - 1]


# (S, query heads per KV head, KV heads, head size, cache dtype): the dense
# cache's block is decode_block(S) — 128 at S 512, 1024 at S 2048
DENSE_CASES = [
    (512, 1, 2, 128, "bfloat16"),
    (512, 12, 1, 48, "float32"),
    (512, 8, 1, 256, "bfloat16"),
    (2048, 4, 1, 256, "bfloat16"),
    (2048, 8, 1, 48, "bfloat16"),
    (2048, 1, 2, 128, "float32"),
]


@pytest.mark.parametrize("s,m,kvh,hs,dtype", DENSE_CASES)
def test_plain_bf16_decode_matches_jax_at_the_block_edges(s, m, kvh, hs, dtype):
    bk = A.decode_block(s)
    assert bk == {512: 128, 2048: 1024}[s]
    pos = _edges(bk, s)
    b, h = len(pos), m * kvh
    rng = np.random.default_rng(s + m + hs)
    k, v, q, kc, vc = _draw(rng, dtype, (b, 1, kvh, s, hs), (b, 1, kvh, s, hs), (b, h, hs),
                            (b, kvh, hs), (b, kvh, hs))
    pos_t, pos_j = torch.tensor(pos, dtype=torch.int32), jnp.asarray(pos, jnp.int32)
    got = A.attention_decode(_t(q, dtype), _t(k, dtype), _t(v, dtype), 0, pos_t, _t(kc, dtype),
                             _t(vc, dtype))
    want = attention_decode_pallas(_j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.int32(0), pos_j,
                                   _j(kc, dtype), _j(vc, dtype), interpret=True)
    _check(got, want, dtype, "K1")
    qkv = np.concatenate([q, kc, vc], axis=1)
    fused = A.attention_decode_fused(_t(qkv, dtype), _t(k, dtype), _t(v, dtype), 0, pos_t, h)
    want = jax_decode_fused(_j(qkv, dtype), _j(k, dtype), _j(v, dtype), jnp.int32(0), pos_j,
                            n_heads=h, interpret=True)
    _check(fused, want, dtype, "K5")
    assert torch.equal(fused, got)


# (page size = the block, pages a slot, query heads per KV head, KV heads,
# head size, cache dtype)
PAGED_CASES = [
    (128, 4, 8, 1, 256, "bfloat16"),
    (512, 2, 4, 1, 128, "float32"),
    (128, 3, 12, 1, 48, "bfloat16"),
    (512, 2, 1, 2, 48, "bfloat16"),
    (128, 4, 1, 4, 128, "float32"),
]


@pytest.mark.parametrize("ps,max_pages,m,kvh,hs,dtype", PAGED_CASES)
def test_plain_bf16_paged_decode_matches_jax_at_the_page_edges(ps, max_pages, m, kvh, hs,
                                                               dtype):
    s = ps * max_pages
    pos = _edges(ps, s)
    b, h = len(pos), m * kvh
    n_pages = b * max_pages + 1
    rng = np.random.default_rng(ps + m + hs + 1)
    k, v, q, kc, vc = _draw(rng, dtype, (1, kvh, n_pages, ps, hs), (1, kvh, n_pages, ps, hs),
                            (b, h, hs), (b, kvh, hs), (b, kvh, hs))
    table = rng.permutation(np.arange(1, n_pages))[: b * max_pages].reshape(b, max_pages)
    table = table.astype(np.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    got = A.attention_decode_paged(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                   torch.from_numpy(table), 0, pos_t, _t(kc, dtype),
                                   _t(vc, dtype))
    want = jax_decode_paged(_j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(table),
                            jnp.int32(0), jnp.asarray(pos, jnp.int32), _j(kc, dtype),
                            _j(vc, dtype), interpret=True)
    _check(got, want, dtype, "K6")
