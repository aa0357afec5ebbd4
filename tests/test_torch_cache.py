"""The port's plain KV cache writers (hip_llama_tpu_torch/ops/cache.py)
against the JAX package: the decode-step commit vs kv_commit_rows
(interpret mode) and the XLA _write_kv_rows, the prefill chunk writer vs
kv_write_chunk (interpret mode) and scatter_kv_chunk. Pure data movement,
so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hip_llama_tpu.models.llama import KVCache as JKVCache
from hip_llama_tpu.models.llama import _write_kv_rows, scatter_kv_chunk
from hip_llama_tpu.ops.cache import kv_commit_rows as jax_kv_commit_rows
from hip_llama_tpu.ops.cache import kv_write_chunk as jax_kv_write_chunk
from hip_llama_tpu_torch.models.llama import KVCache
from hip_llama_tpu_torch.ops import cache as C

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [None, [True, False, True, True]])
def test_plain_commit_matches_jax(dtype, valid):
    rng = np.random.default_rng(0)
    b, n_layers, kvh, s, hs = 4, 3, 2, 32, 8
    cache = [rng.standard_normal((b, n_layers, kvh, s, hs)).astype(np.float32) for _ in range(2)]
    rows = [rng.standard_normal((n_layers, b, kvh, hs)).astype(np.float32) for _ in range(2)]
    pos = [0, 31, 7, 19]
    (kj, kt), (vj, vt) = (_pair(c, dtype) for c in cache)
    (krj, krt), (vrj, vrt) = (_pair(r, dtype) for r in rows)
    pos_j = jnp.asarray(pos, jnp.int32)
    valid_j = None if valid is None else jnp.asarray(valid)
    valid_t = None if valid is None else torch.tensor(valid, dtype=torch.int32)

    got = C.kv_commit_rows(KVCache(kt, vt), krt, vrt, torch.tensor(pos, dtype=torch.int32), valid_t)
    pallas = jax_kv_commit_rows(JKVCache(kj, vj), krj, vrj, pos_j, valid_j, interpret=True)
    for plane, want, rj, cj in ((got.k, pallas.k, krj, kj), (got.v, pallas.v, vrj, vj)):
        assert _same(plane, want)
        assert _same(plane, _write_kv_rows(cj, rj, pos_j, valid_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_write_chunk_matches_jax(dtype):
    rng = np.random.default_rng(1)
    b, n_layers, kvh, s, hs, t = 4, 2, 2, 64, 16, 8
    cache = [rng.standard_normal((b, n_layers, kvh, s, hs)).astype(np.float32) for _ in range(2)]
    rows = [rng.standard_normal((b, t, kvh, hs)).astype(np.float32) for _ in range(2)]
    # a full chunk, a bystander (valid 0), a partial chunk, and a window past
    # the end of the cache (start + T > S) whose valid rows end exactly at S
    start = [0, 12, 30, s - 5]
    valid = [t, 0, 3, 5]
    (kj, kt), (vj, vt) = (_pair(c, dtype) for c in cache)
    (krj, krt), (vrj, vrt) = (_pair(r, dtype) for r in rows)
    st_j, va_j = jnp.asarray(start, jnp.int32), jnp.asarray(valid, jnp.int32)
    layer = 1
    got = C.kv_write_chunk(KVCache(kt, vt), krt, vrt, layer, torch.tensor(start, dtype=torch.int32),
                           torch.tensor(valid, dtype=torch.int32))

    def scatter(c, n, st, v):
        return scatter_kv_chunk(c, n, st, v, l=layer, t=t, s=s)

    for plane, cj, rj in ((got.k, kj, krj), (got.v, vj, vrj)):
        # the JAX writer donates its cache: hand it a copy
        assert _same(plane, jax_kv_write_chunk(jnp.array(cj), rj, jnp.int32(layer), st_j, va_j,
                                               interpret=True))
        assert _same(plane, jax.vmap(scatter)(cj, rj, st_j, va_j))


def test_plain_write_chunk_drops_rows_past_the_window():
    """start + valid > S: rows that would land at or past S are dropped and
    nothing else moves (the contract the CUDA kernel keeps too)."""
    b, n_layers, kvh, s, hs, t = 1, 1, 1, 16, 8, 8
    cache = KVCache(torch.zeros(b, n_layers, kvh, s, hs), torch.zeros(b, n_layers, kvh, s, hs))
    rows = torch.arange(1, t + 1, dtype=torch.float32)[None, :, None, None].expand(b, t, kvh, hs)
    C.kv_write_chunk(cache, rows.contiguous(), rows.contiguous(), 0,
                     torch.tensor([12], dtype=torch.int32), torch.tensor([8], dtype=torch.int32))
    assert cache.k[0, 0, 0, :, 0].tolist() == [0.0] * 12 + [1.0, 2.0, 3.0, 4.0]
